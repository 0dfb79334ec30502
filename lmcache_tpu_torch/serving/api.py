"""OpenAI-compatible HTTP front for the serving engines, on the standard
library (the port of ``lmcache_tpu/serving/api.py``).

``/v1/completions`` and ``/v1/chat/completions`` (both optionally
SSE-streamed), ``/v1/models``, ``/health`` and ``/metrics``. The scheduler
runs on a dedicated thread; the HTTP handlers, on an ``asyncio`` server of
their own, submit requests thread-safely and await completion. Any of the
four engines serves (they share ``ServingEngine``'s interface).

The HTTP layer is a small HTTP/1.1 one (``asyncio.start_server``): a request
line, headers and a ``Content-Length`` body; every response carries
``Connection: close`` (a streamed one ends with the connection); 400 on a
body that is not a JSON object, 404 on an unknown path, 405 on a known path
with another method, 413 on a body of ``MAX_BODY`` bytes or more.

OpenAI-compat surface, request parsing and response bodies field for field
as the JAX server's: ``stop`` strings (with streamed hold-back so a
partially-emitted stop string never reaches the client),
``stop_token_ids``, ``logprobs`` / ``top_logprobs``, ``n > 1`` choices
(seed + i for choice i), ``stream_options: {"include_usage": true}``,
``usage`` with ``prompt_tokens_details.cached_tokens`` and ``ttft_ms``, and
``finish_reason`` from the actual stop cause (a request that ends on EOS
exactly at the ``max_tokens`` boundary reports "stop").

Prompts are accepted as token-id lists (the framework is
tokenizer-agnostic); pass ``tokenizer``/``detokenizer`` callables to serve
plain strings.
"""

import asyncio
import json
import threading
import time
from http import HTTPStatus
from typing import Callable, List, Optional

from lmcache_tpu_torch import metrics
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)

logger = init_logger(__name__)

# the largest request head (request line and headers) read, in bytes
MAX_HEAD = 64 * 1024
# a POST body of this many bytes or more is answered 413 (and dropped), as
# aiohttp's default client_max_size answers the JAX server's
MAX_BODY = 1024 ** 2


class _HTTPError(Exception):

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class APIServer:

    def __init__(
        self,
        engine,
        model_name: str = "lmcache-tpu",
        tokenizer: Optional[Callable[[str], list]] = None,
        detokenizer: Optional[Callable[[list], str]] = None,
        chat_template: Optional[Callable[[list], object]] = None,
    ):
        self.engine = engine
        self.model_name = model_name
        self.tokenizer = tokenizer
        self.detokenizer = detokenizer or (
            lambda toks: " ".join(map(str, toks)))
        # renders /v1/chat/completions ``messages`` into a prompt (string or
        # token ids), e.g. a tokenizer's chat template; without one a
        # generic role-tagged text template feeds the plain tokenizer
        self.chat_template = chat_template
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._routes = {
            "/health": ("GET", self._health),
            "/metrics": ("GET", self._metrics),
            "/v1/models": ("GET", self._models),
            "/v1/completions": ("POST", self._completions),
            "/v1/chat/completions": ("POST", self._chat_completions),
        }
        self._http_loop: Optional[asyncio.AbstractEventLoop] = None
        self._http_thread: Optional[threading.Thread] = None

    # -- scheduler thread ---------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                busy = self.engine.has_work()
                if busy:
                    self.engine.step()
            if not busy:
                time.sleep(0.002)

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="lmc-scheduler", daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the scheduler thread and the listener of :meth:`listen`."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        self._close_listener()

    # -- request parsing / submission ----------------------------------------

    @staticmethod
    def _parse_sampling(body) -> SamplingParams:
        # chat uses top_logprobs for the alternatives count; completions
        # passes logprobs=N directly. Either shape lands in
        # SamplingParams.logprobs (engine records that many per token).
        lp = body.get("logprobs", 0)
        if lp is True:  # chat API: logprobs is a bool + top_logprobs int
            lp = max(int(body.get("top_logprobs", 0)), 1)
        return SamplingParams(
            max_new_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=int(body.get("seed", 0)),
            stop_token_ids=tuple(body.get("stop_token_ids", ())),
            logprobs=int(lp or 0),
        )

    @staticmethod
    def _parse_stops(body) -> tuple:
        stop = body.get("stop", ())
        if isinstance(stop, str):
            stop = (stop,)
        stops = tuple(s for s in stop if s)
        if len(stops) > 4:
            raise ValueError("stop supports at most 4 strings")
        return stops

    def _make_stop_checker(self, stops: tuple):
        """Text-level stop detector installed on the Request (the engine
        is tokenizer-agnostic; detokenization lives here). Returns the
        character offset where the earliest stop string begins, or
        None."""
        detok = self.detokenizer

        def check(output_tokens) -> Optional[int]:
            text = detok(list(output_tokens))
            best = None
            for s in stops:
                i = text.find(s)
                if i != -1 and (best is None or i < best):
                    best = i
            return best

        return check

    def _submit(self, prompt, sampling: SamplingParams, *, stops=(),
                context_chunks=None, n: int = 1) -> List[Request]:
        """Submit ``n`` choices for one API request. Seeded requests use
        seed + i for choice i so choices differ but each is individually
        reproducible."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string prompts need a tokenizer; pass token ids")
            prompt = self.tokenizer(prompt)
        if n < 1:
            raise ValueError("n must be >= 1")
        reqs = []
        for i in range(n):
            s = sampling if (n == 1 or not sampling.seed) else \
                SamplingParams(**{**sampling.__dict__,
                                  "seed": sampling.seed + i})
            req = Request(prompt, s, context_chunks=context_chunks)
            if stops:
                req.stop_checker = self._make_stop_checker(stops)
            reqs.append(req)
        with self._lock:
            for req in reqs:
                self.engine.add_request(req)
        return reqs

    async def _await_done(self, reqs: List[Request]):
        while any(r.state != RequestState.FINISHED for r in reqs):
            await asyncio.sleep(0.005)

    # -- response rendering ---------------------------------------------------

    @staticmethod
    def _finish_reason(req: Request) -> str:
        """The actual stop cause recorded when ``is_finished`` first fired
        ("stop" for EOS / stop_token_ids / stop strings, "length" for the
        max_tokens cap)."""
        return req.finish_reason or "length"

    def _final_text(self, req: Request) -> str:
        """Detokenized output, truncated at the stop string (OpenAI
        excludes the matched stop text from the response)."""
        text = self.detokenizer(req.output_tokens)
        if req.stop_text_offset is not None:
            text = text[:req.stop_text_offset]
        return text

    def _completion_logprobs(self, req: Request) -> Optional[dict]:
        """Completions-API logprobs object."""
        if req.logprobs is None:
            return None
        toks, lps, tops = [], [], []
        for rec in req.logprobs:
            toks.append(self.detokenizer([rec["token"]]))
            lps.append(rec["logprob"])
            tops.append({
                self.detokenizer([tid]): lp for tid, lp in rec["top"]
            })
        return {
            "tokens": toks,
            "token_logprobs": lps,
            "top_logprobs": tops,
        }

    def _chat_logprobs(self, req: Request) -> Optional[dict]:
        """Chat-API logprobs object ({"content": [...]})."""
        if req.logprobs is None:
            return None
        content = []
        for rec in req.logprobs:
            content.append({
                "token": self.detokenizer([rec["token"]]),
                "logprob": rec["logprob"],
                "top_logprobs": [{
                    "token": self.detokenizer([tid]),
                    "logprob": lp,
                } for tid, lp in rec["top"]],
            })
        return {"content": content}

    @staticmethod
    def _usage(reqs: List[Request]) -> dict:
        """Aggregate usage: the prompt counts once (choices share it),
        completions sum over choices."""
        completion = sum(len(r.output_tokens) for r in reqs)
        r0 = reqs[0]
        return {
            "prompt_tokens": r0.num_prompt_tokens,
            "completion_tokens": completion,
            "total_tokens": r0.num_prompt_tokens + completion,
            # the OpenAI prompt-caching field, so standard clients see the
            # reuse; cached_prefix_tokens kept as the legacy alias
            "prompt_tokens_details": {"cached_tokens": r0.cached_prefix_len},
            "cached_prefix_tokens": r0.cached_prefix_len,
            "ttft_ms": (round(r0.ttft_s * 1e3, 2) if r0.ttft_s else None),
        }

    # -- streaming core -------------------------------------------------------

    async def _stream(self, writer, reqs: List[Request], *, stops,
                      include_usage: bool, chat: bool):
        """SSE-stream ``reqs`` as one multi-choice response.

        Without stop strings, chunks are per-token. With stop strings,
        chunks carry TEXT deltas and the stream holds back the longest
        suffix that could still be the prefix of a stop string, so a
        partially-generated stop string is never emitted."""
        writer.write(_head(HTTPStatus.OK, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        }))
        rid = reqs[0].request_id
        obj = "chat.completion.chunk" if chat else "text_completion"
        cid = f"{'chatcmpl' if chat else 'cmpl'}-{rid}"
        holdback = max((len(s) for s in stops), default=1) - 1

        def chunk_payload(index, text, tok=None, finish=None, first=False):
            if chat:
                delta = {} if text is None else {"content": text}
                if first:
                    delta["role"] = "assistant"
                choice = {"index": index, "delta": delta,
                          "finish_reason": finish}
            else:
                choice = {"index": index, "text": text or "",
                          "finish_reason": finish}
            if tok is not None:
                choice["token"] = tok
            return {"id": cid, "object": obj, "model": self.model_name,
                    "choices": [choice]}

        async def send(payload):
            writer.write(f"data: {json.dumps(payload)}\n\n".encode())
            await writer.drain()

        sent_toks = [0] * len(reqs)  # per-token mode cursor
        sent_chars = [0] * len(reqs)  # text-delta mode cursor
        first = [True] * len(reqs)
        done = [False] * len(reqs)
        while not all(done):
            for i, req in enumerate(reqs):
                if done[i]:
                    continue
                finished = req.state == RequestState.FINISHED
                if stops:
                    text = self._final_text(req)
                    limit = len(text) if finished else max(
                        sent_chars[i], len(text) - holdback)
                    if limit > sent_chars[i]:
                        await send(chunk_payload(
                            i, text[sent_chars[i]:limit], first=first[i]))
                        first[i] = False
                        sent_chars[i] = limit
                else:
                    toks = list(req.output_tokens)
                    for tok in toks[sent_toks[i]:]:
                        await send(chunk_payload(
                            i, self.detokenizer([tok]), tok=tok,
                            first=first[i]))
                        first[i] = False
                    sent_toks[i] = len(toks)
                if finished and (stops or sent_toks[i] == len(
                        req.output_tokens)):
                    # terminal chunk: clients that stop on finish_reason
                    # must see one before [DONE]
                    await send(chunk_payload(
                        i, None if chat else "",
                        finish=self._finish_reason(req)))
                    done[i] = True
            if not all(done):
                await asyncio.sleep(0.005)
        if include_usage:
            # OpenAI stream_options.include_usage: a final chunk with empty
            # choices carrying the aggregate usage
            await send({"id": cid, "object": obj, "model": self.model_name,
                        "choices": [], "usage": self._usage(reqs)})
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    def _render_chat(self, messages):
        """Render chat ``messages`` to a prompt (string or token ids).

        Each message must be ``{"role": ..., "content": ...}``. With no
        ``chat_template``, a generic role-tagged text template is used
        (model-correct templates belong to the tokenizer layer)."""
        for m in messages:
            if not isinstance(m, dict) or "content" not in m:
                raise ValueError(
                    "each message needs 'role' and 'content'")
        if self.chat_template is not None:
            return self.chat_template(messages)
        text = "".join(
            f"{m.get('role', 'user')}: {m['content']}\n" for m in messages
        ) + "assistant:"
        return text

    # -- handlers -------------------------------------------------------------
    # each takes (parsed JSON body or None, writer) and returns
    # (status, body, content type), or None where it wrote a stream itself

    async def _health(self, body, writer):
        return HTTPStatus.OK, {"status": "ok"}, None

    async def _metrics(self, body, writer):
        return HTTPStatus.OK, metrics.prometheus_text(), "text/plain"

    async def _models(self, body, writer):
        return HTTPStatus.OK, {
            "object": "list",
            "data": [{
                "id": self.model_name,
                "object": "model",
                "owned_by": "lmcache-tpu",
            }],
        }, None

    async def _completions(self, body, writer):
        try:
            sampling = self._parse_sampling(body)
            stops = self._parse_stops(body)
            reqs = self._submit(
                body.get("prompt", []), sampling, stops=stops,
                context_chunks=body.get("context_chunks"),
                n=int(body.get("n", 1)))
        except ValueError as e:
            return HTTPStatus.BAD_REQUEST, {"error": str(e)}, None

        if body.get("stream", False):
            include_usage = bool(
                body.get("stream_options", {}).get("include_usage", False))
            await self._stream(writer, reqs, stops=stops,
                               include_usage=include_usage, chat=False)
            return None

        await self._await_done(reqs)
        return HTTPStatus.OK, {
            "id": f"cmpl-{reqs[0].request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": i,
                "text": self._final_text(req),
                "tokens": req.output_tokens,
                "logprobs": self._completion_logprobs(req),
                "finish_reason": self._finish_reason(req),
            } for i, req in enumerate(reqs)],
            "usage": self._usage(reqs),
        }, None

    async def _chat_completions(self, body, writer):
        """OpenAI-style chat endpoint: ``messages`` are rendered to a prompt
        by ``chat_template`` (or a generic role-tagged fallback through the
        tokenizer) and served by the same engine path as /v1/completions.
        The multi-turn prefix is what the cache engine reuses: every
        follow-up turn hits the stored KV of the conversation so far."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            return (HTTPStatus.BAD_REQUEST,
                    {"error": "messages must be a non-empty list"}, None)
        try:
            prompt = self._render_chat(messages)
            sampling = self._parse_sampling(body)
            stops = self._parse_stops(body)
            reqs = self._submit(prompt, sampling, stops=stops,
                                context_chunks=body.get("context_chunks"),
                                n=int(body.get("n", 1)))
        except ValueError as e:
            return HTTPStatus.BAD_REQUEST, {"error": str(e)}, None

        if body.get("stream", False):
            include_usage = bool(
                body.get("stream_options", {}).get("include_usage", False))
            await self._stream(writer, reqs, stops=stops,
                               include_usage=include_usage, chat=True)
            return None

        await self._await_done(reqs)
        return HTTPStatus.OK, {
            "id": f"chatcmpl-{reqs[0].request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": i,
                "message": {
                    "role": "assistant",
                    "content": self._final_text(req),
                },
                "tokens": req.output_tokens,
                "logprobs": self._chat_logprobs(req),
                "finish_reason": self._finish_reason(req),
            } for i, req in enumerate(reqs)],
            "usage": self._usage(reqs),
        }, None

    # -- HTTP/1.1 -------------------------------------------------------------

    async def _read_request(self, reader):
        """(method, path, Content-Length) of one request, its body unread."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise _HTTPError(HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE,
                             "request head too large")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _HTTPError(HTTPStatus.BAD_REQUEST, "bad request line")
        method, target = parts[0].upper(), parts[1]
        headers = {}
        for line in lines[1:]:
            if line:
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0))
        except ValueError:
            raise _HTTPError(HTTPStatus.BAD_REQUEST, "bad Content-Length")
        if length < 0:
            raise _HTTPError(HTTPStatus.BAD_REQUEST, "bad Content-Length")
        return method, target.split("?", 1)[0], length

    async def _handle(self, reader, writer):
        """Serve one request on one connection, then close it."""
        try:
            try:
                method, path, length = await self._read_request(reader)
                route = self._routes.get(path)
                if route is None:
                    raise _HTTPError(HTTPStatus.NOT_FOUND, "not found")
                if method != route[0]:
                    raise _HTTPError(HTTPStatus.METHOD_NOT_ALLOWED,
                                     "method not allowed")
                body = None
                if method == "POST":
                    if length >= MAX_BODY:
                        # read and dropped a piece at a time, so the client
                        # gets the answer rather than a reset connection
                        while length:
                            length -= len(await reader.readexactly(
                                min(length, MAX_HEAD)))
                        raise _HTTPError(
                            HTTPStatus.REQUEST_ENTITY_TOO_LARGE,
                            f"request body of {MAX_BODY} bytes or more")
                    try:
                        body = json.loads(await reader.readexactly(length))
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        raise _HTTPError(HTTPStatus.BAD_REQUEST,
                                         "invalid JSON")
                    if not isinstance(body, dict):
                        raise _HTTPError(
                            HTTPStatus.BAD_REQUEST,
                            "request body must be a JSON object")
                out = await route[1](body, writer)
            except _HTTPError as e:
                out = e.status, {"error": str(e)}, None
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except Exception as e:  # a handler's fault: 500, keep serving
                logger.exception("API handler failed")
                out = (HTTPStatus.INTERNAL_SERVER_ERROR,
                       {"error": f"{type(e).__name__}: {e}"}, None)
            if out is not None:
                status, payload, ctype = out
                if ctype is None:
                    data = json.dumps(payload).encode()
                    ctype = "application/json; charset=utf-8"
                else:
                    data = payload.encode()
                writer.write(_head(status, {
                    "Content-Type": ctype,
                    "Content-Length": str(len(data))}) + data)
            await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve HTTP on ``host:port`` from a thread of its own (port 0: an
        ephemeral port) and return the bound port. The scheduler thread is
        :meth:`start`'s; :meth:`stop` ends both."""
        if self._http_thread is not None:
            raise RuntimeError("already listening")
        ready = threading.Event()
        box = {}

        def serve():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                server = loop.run_until_complete(asyncio.start_server(
                    self._handle, host, port, limit=MAX_HEAD))
            except Exception as e:
                box["error"] = e
                ready.set()
                loop.close()
                return
            self._http_loop = loop
            box["port"] = server.sockets[0].getsockname()[1]
            ready.set()
            try:
                loop.run_forever()
            finally:
                server.close()
                loop.run_until_complete(server.wait_closed())
                loop.close()

        self._http_thread = threading.Thread(target=serve, name="lmc-http",
                                             daemon=True)
        self._http_thread.start()
        ready.wait()
        if "error" in box:
            self._http_thread = None
            raise box["error"]
        logger.info("API server on %s:%d", host, box["port"])
        return box["port"]

    def _close_listener(self):
        thread, loop = self._http_thread, self._http_loop
        self._http_thread = self._http_loop = None  # before run() can wake
        if thread is None:
            return
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)

    def run(self, host: str = "localhost", port: int = 8000):
        """Start the scheduler and serve HTTP on ``host:port`` (through
        :meth:`listen`) until interrupted."""
        self.start()
        try:
            self.listen(host, port)
            thread = self._http_thread
            while thread.is_alive():
                thread.join(timeout=1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def _head(status: int, headers: dict) -> bytes:
    status = HTTPStatus(status)
    lines = [f"HTTP/1.1 {status.value} {status.phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines += ["Connection: close", "", ""]
    return "\r\n".join(lines).encode("latin-1")
