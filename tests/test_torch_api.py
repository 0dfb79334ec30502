"""The port's OpenAI-compatible HTTP front (``lmcache_tpu_torch.serving.api``,
the standard library's asyncio) against the JAX package's (aiohttp), on the
CPU.

One JAX server (``ServingEngine(use_pallas=False)``) and one port server
(``ServingEngine(device="cpu")``) run over the same tiny weights (the JAX
``init_params`` carried across with ``params_from_jax``), each on a real
port; the same request bodies go to both through ``http.client``. Each
response's JSON must agree field for field apart from ``id``, ``created``
and ``usage.ttft_ms``: tokens and text exactly, logprobs within
``LP_ATOL`` (``tests/test_torch_decode_options.py``'s). Streamed responses
are compared event by event. One prompt length and one chat length keep the
JAX engine to a few compiles."""

import asyncio
import http.client
import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from lmcache_tpu.serving.api import APIServer as JAPIServer  # noqa: E402
from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,  # noqa
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402
from lmcache_tpu_torch.serving import (MLAPagedServingEngine,  # noqa: E402
                                       MLAServingEngine, PagedServingEngine,
                                       Request, SamplingParams, ServingEngine)
from lmcache_tpu_torch.serving.api import MAX_BODY, APIServer  # noqa: E402

LP_ATOL = 1e-4  # tests/test_torch_decode_options.py: fp32 log-softmax
MAX_SEQ = 128
PROMPT = np.random.default_rng(0).integers(0, 512, 9).tolist()
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello there"}]


def template(messages):
    """A toy id-level chat template (tests/test_api.py's)."""
    out = []
    for m in messages:
        out.extend((7 + sum(map(ord, m["role"]))) % 512 for _ in range(2))
        out.extend((3 * ord(c) + 11) % 512 for c in m["content"])
    return out


def _serve_aiohttp(app):
    """The JAX server's aiohttp app on 127.0.0.1, an ephemeral port, from a
    thread of its own. Returns (port, stop)."""
    from aiohttp import web
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.run_until_complete(runner.cleanup())
        loop.close()

    return port, stop


@pytest.fixture(scope="module")
def servers():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jsrv = JAPIServer(JServingEngine(jcfg, jparams, max_batch=2,
                                     max_seq=MAX_SEQ, use_pallas=False),
                      model_name="tiny", chat_template=template)
    tcfg = tl.LlamaConfig.tiny(n_layers=2)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    tsrv = APIServer(ServingEngine(tcfg, tparams, max_batch=2,
                                   max_seq=MAX_SEQ, device="cpu"),
                     model_name="tiny", chat_template=template)
    jsrv.start()
    tsrv.start()
    jport, jstop = _serve_aiohttp(jsrv.build_app())
    tport = tsrv.listen("127.0.0.1", 0)
    yield {"jax": jport, "port": tport, "engine": tsrv.engine,
           "cfg": tcfg, "params": tparams}
    jstop()
    jsrv.stop()
    tsrv.stop()


def request(port, method, path, body=None, raw=None):
    """(status, content type, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    headers = {"Content-Type": "application/json"} if data is not None else {}
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), out


def events(raw: bytes):
    """The JSON payloads of an SSE body, and whether it ends in [DONE]."""
    chunks = [c for c in raw.decode().split("\n\n") if c.startswith("data: ")]
    done = chunks[-1] == "data: [DONE]"
    return [json.loads(c[6:]) for c in chunks if c != "data: [DONE]"], done


def _strip(x):
    """A response without the fields that differ by nature: ids, creation
    times and the TTFT."""
    if isinstance(x, dict):
        return {k: (_strip(v) if k != "usage" else
                    {uk: uv for uk, uv in v.items() if uk != "ttft_ms"})
                for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def assert_same(got, want, path="", lp=False):
    """Field for field; floats under a logprobs key within LP_ATOL."""
    lp = lp or "logprob" in path
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}", lp)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", lp)
    elif isinstance(want, float) and lp:
        assert abs(got - want) <= LP_ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(servers, method, path, body=None, raw=None):
    """The same request to both servers: (status, content type, body) of
    the port's and of the JAX server's response."""
    out = []
    for name in ("port", "jax"):
        status, ctype, data = request(servers[name], method, path, body, raw)
        out.append((status, ctype, data))
    return out


def test_health_and_models(servers):
    for path in ("/health", "/v1/models"):
        (ts, tc, tb), (js, jc, jb) = both(servers, "GET", path)
        assert ts == js == 200 and tc.startswith("application/json")
        assert json.loads(tb) == json.loads(jb)


COMPLETIONS = {
    "plain": {"prompt": PROMPT, "max_tokens": 4},
    "n2-seeded": {"prompt": PROMPT, "max_tokens": 3, "n": 2, "seed": 5},
    "logprobs": {"prompt": PROMPT, "max_tokens": 3, "logprobs": 2},
    "stop-token-ids": {"prompt": PROMPT, "max_tokens": 6,
                       "stop_token_ids": [511]},
}


@pytest.mark.parametrize("name", sorted(COMPLETIONS))
def test_completion_matches_jax(servers, name):
    (ts, _, tb), (js, _, jb) = both(servers, "POST", "/v1/completions",
                                   COMPLETIONS[name])
    assert ts == js == 200
    got, want = json.loads(tb), json.loads(jb)
    assert_same(_strip(got), _strip(want))
    assert got["usage"]["ttft_ms"] is not None


def _greedy_tokens(servers, n):
    _, _, data = request(servers["port"], "POST", "/v1/completions",
                         {"prompt": PROMPT, "max_tokens": n})
    return json.loads(data)["choices"][0]["tokens"]


def test_finish_reason_at_length_boundary_matches_jax(servers):
    """A stop token that lands exactly on max_tokens reports "stop"."""
    toks = _greedy_tokens(servers, 4)
    body = {"prompt": PROMPT, "max_tokens": 4, "stop_token_ids": [toks[3]]}
    (ts, _, tb), (js, _, jb) = both(servers, "POST", "/v1/completions", body)
    got, want = json.loads(tb), json.loads(jb)
    assert_same(_strip(got), _strip(want))
    if toks[3] not in toks[:3]:
        assert got["choices"][0]["finish_reason"] == "stop"


def _stop_string(servers):
    """A stop string from the greedy output's text: its third token's
    digits with their leading space."""
    toks = _greedy_tokens(servers, 6)
    return " " + str(toks[2])


@pytest.mark.parametrize("stream", [False, True])
def test_stop_string_matches_jax(servers, stream):
    body = {"prompt": PROMPT, "max_tokens": 6,
            "stop": [_stop_string(servers), "never"], "stream": stream}
    (ts, tc, tb), (js, jc, jb) = both(servers, "POST", "/v1/completions",
                                      body)
    assert ts == js == 200
    if not stream:
        got = json.loads(tb)
        assert_same(_strip(got), _strip(json.loads(jb)))
        assert got["choices"][0]["finish_reason"] == "stop"
        return
    assert tc.startswith("text/event-stream")
    (got, tdone), (want, jdone) = events(tb), events(jb)
    assert tdone and jdone
    assert_same(_strip(got), _strip(want))
    # the hold-back kept every partial stop string out of the deltas
    text = "".join(e["choices"][0]["text"] for e in got)
    assert body["stop"][0] not in text


@pytest.mark.parametrize("include_usage", [False, True])
def test_streamed_completion_matches_jax(servers, include_usage):
    body = {"prompt": PROMPT, "max_tokens": 4, "stream": True,
            "stream_options": {"include_usage": include_usage}}
    (ts, _, tb), (js, _, jb) = both(servers, "POST", "/v1/completions", body)
    assert ts == js == 200
    (got, tdone), (want, jdone) = events(tb), events(jb)
    assert tdone and jdone
    assert_same(_strip(got), _strip(want))
    # the streamed tokens are the non-streamed response's
    toks = [e["choices"][0]["token"] for e in got
            if e["choices"] and "token" in e["choices"][0]]
    assert toks == _greedy_tokens(servers, 4)


CHATS = {
    "plain": {"messages": MESSAGES, "max_tokens": 4},
    "logprobs": {"messages": MESSAGES, "max_tokens": 3, "logprobs": True,
                 "top_logprobs": 2},
    "streamed": {"messages": MESSAGES, "max_tokens": 3, "stream": True,
                 "stream_options": {"include_usage": True}},
}


@pytest.mark.parametrize("name", sorted(CHATS))
def test_chat_matches_jax(servers, name):
    body = CHATS[name]
    (ts, _, tb), (js, _, jb) = both(servers, "POST", "/v1/chat/completions",
                                   body)
    assert ts == js == 200
    if body.get("stream"):
        (got, tdone), (want, jdone) = events(tb), events(jb)
        assert tdone and jdone
        assert got[0]["choices"][0]["delta"]["role"] == "assistant"
    else:
        got, want = json.loads(tb), json.loads(jb)
        assert got["choices"][0]["message"]["role"] == "assistant"
    assert_same(_strip(got), _strip(want))


BAD = {
    "invalid-json": ("POST", "/v1/completions", None, b"{not json"),
    "string-prompt-without-tokenizer": (
        "POST", "/v1/completions", {"prompt": "hello", "max_tokens": 2},
        None),
    "n-zero": ("POST", "/v1/completions",
               {"prompt": PROMPT, "max_tokens": 2, "n": 0}, None),
    "five-stops": ("POST", "/v1/completions",
                   {"prompt": PROMPT, "stop": list("abcde")}, None),
    "too-long": ("POST", "/v1/completions",
                 {"prompt": PROMPT, "max_tokens": MAX_SEQ}, None),
    "chat-no-messages": ("POST", "/v1/chat/completions", {"messages": []},
                         None),
    "chat-bad-message": ("POST", "/v1/chat/completions",
                         {"messages": [{"role": "user"}]}, None),
    "chat-invalid-json": ("POST", "/v1/chat/completions", None, b"[1,"),
    "unknown-path": ("GET", "/v1/nothing", None, None),
    "get-completions": ("GET", "/v1/completions", None, None),
    "post-health": ("POST", "/health", None, b"{}"),
    # aiohttp's default body limit: 413 from MAX_BODY bytes on
    "body-at-the-limit": ("POST", "/v1/completions", None,
                          b"{" + b" " * (MAX_BODY - 1)),
    "body-under-the-limit": ("POST", "/v1/completions", None,
                             b"{" + b" " * (MAX_BODY - 2)),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_requests_match_jax(servers, name):
    method, path, body, raw = BAD[name]
    (ts, tc, tb), (js, jc, jb) = both(servers, method, path, body, raw)
    assert ts == js and ts in (400, 404, 405, 413)
    if ts == 400:
        assert json.loads(tb) == json.loads(jb)


def test_multiturn_chat_cached_tokens_climb():
    """Three chat turns on the port alone over a cache tier: each turn's
    prompt extends the last, so cached_tokens climbs. The store-back of a
    finished request runs on the scheduler thread: taking the server's lock
    (no step in flight) and flushing the tier waits for it."""
    cfg = tl.LlamaConfig.tiny(n_layers=2)
    params = tl.init_params(cfg, device="cpu")
    ce = LMCacheEngine(
        LMCacheEngineConfig(local_device="cpu", chunk_size=16),
        LMCacheEngineMetadata(model_name="tiny-chat", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    srv = APIServer(ServingEngine(cfg, params, max_batch=2, max_seq=256,
                                  cache_engine=ce, device="cpu"),
                    model_name="tiny-chat", chat_template=template)
    srv.start()
    port = srv.listen()
    try:
        msgs = [{"role": "system", "content": "answer in one line " * 2},
                {"role": "user", "content": "tell me about caches"}]
        cached = []
        for turn in range(3):
            status, _, data = request(port, "POST", "/v1/chat/completions",
                                      {"messages": msgs, "max_tokens": 4})
            assert status == 200
            out = json.loads(data)
            cached.append(out["usage"]["prompt_tokens_details"]
                          ["cached_tokens"])
            with srv._lock:
                ce.engine_.flush()
            msgs = msgs + [out["choices"][0]["message"],
                           {"role": "user", "content": f"and turn {turn}?"}]
        assert cached[0] == 0 and 0 < cached[1] < cached[2]
        status, ctype, data = request(port, "GET", "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert b"lmcache_chunks_stored" in data
    finally:
        srv.stop()
        ce.close()


def _engines(cfg, params):
    mcfg = tm.MLAConfig.tiny(n_layers=3, n_routed_experts=4,
                             n_shared_experts=1, n_experts_per_tok=2,
                             moe_hidden_dim=64, first_k_dense_replace=1)
    mparams = tm.init_params(mcfg, device="cpu")
    paged = dict(num_pages=32, page_size=16)
    return {
        "dense": lambda: ServingEngine(cfg, params, max_batch=2,
                                       max_seq=MAX_SEQ, device="cpu"),
        "paged": lambda: PagedServingEngine(cfg, params, max_batch=2,
                                            max_seq=MAX_SEQ, device="cpu",
                                            **paged),
        "mla": lambda: MLAServingEngine(mcfg, mparams, max_batch=2,
                                        max_seq=MAX_SEQ, device="cpu"),
        "mla-paged": lambda: MLAPagedServingEngine(
            mcfg, mparams, max_batch=2, max_seq=MAX_SEQ, device="cpu",
            **paged),
    }


@pytest.mark.parametrize("kind", ["dense", "paged", "mla", "mla-paged"])
def test_serves_every_engine(servers, kind):
    """Each of the four engines behind the port's server gives the tokens
    of the same engine driven directly."""
    make = _engines(servers["cfg"], servers["params"])[kind]
    [direct] = make().generate([np.asarray(PROMPT, np.int32)],
                               SamplingParams(max_new_tokens=4))
    srv = APIServer(make(), model_name=kind)
    srv.start()
    port = srv.listen()
    try:
        status, _, data = request(port, "POST", "/v1/completions",
                                  {"prompt": PROMPT, "max_tokens": 4})
    finally:
        srv.stop()
    assert status == 200
    assert json.loads(data)["choices"][0]["tokens"] == direct.output_tokens


def test_seeded_sampling_matches_engine(servers):
    """n = 2 sampled choices with a seed are the engine's requests seeded
    seed and seed + 1."""
    eng = ServingEngine(servers["cfg"], servers["params"], max_batch=2,
                        max_seq=MAX_SEQ, device="cpu")
    sp = dict(max_new_tokens=5, temperature=1.0, top_k=40)
    reqs = [eng.add_request(Request(np.asarray(PROMPT, np.int32),
                                    SamplingParams(seed=s, **sp)))
            for s in (9, 10)]
    eng.run()
    _, _, data = request(servers["port"], "POST", "/v1/completions",
                         {"prompt": PROMPT, "max_tokens": 5, "n": 2,
                          "seed": 9, "temperature": 1.0, "top_k": 40})
    out = json.loads(data)
    assert [c["tokens"] for c in out["choices"]] == [
        r.output_tokens for r in reqs]
    assert out["usage"]["completion_tokens"] == 10


def test_run_serves_until_stopped(servers):
    """``run`` starts the scheduler and serves on the port it is given until
    ``stop``; then it returns."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    srv = APIServer(ServingEngine(servers["cfg"], servers["params"],
                                  max_batch=2, max_seq=MAX_SEQ, device="cpu"))
    runner = threading.Thread(target=srv.run, args=("127.0.0.1", port))
    runner.start()
    try:
        for _ in range(500):
            try:
                status, _, data = request(port, "POST", "/v1/completions",
                                          {"prompt": PROMPT,
                                           "max_tokens": 4})
                break
            except ConnectionRefusedError:
                runner.join(timeout=0.01)
        assert status == 200
        assert json.loads(data)["choices"][0]["tokens"] == _greedy_tokens(
            servers, 4)
    finally:
        srv.stop()
        runner.join(timeout=30)
    assert not runner.is_alive()


def test_listen_refuses_a_second_listener(servers):
    srv = APIServer(servers["engine"])
    port = srv.listen()
    try:
        assert port > 0
        with pytest.raises(RuntimeError):
            srv.listen()
    finally:
        srv.stop()
