"""A chat client of the API server in the terminal (the JAX package's
``examples/chat_client.py``), on the standard library's ``urllib``.

Start a server first (``online_session.py --serve`` serves one), then:

    python -m lmcache_tpu_torch.examples.chat_client --port 8377

Each line typed is appended to the conversation as text; the server
tokenizes it, streams the completion (server-sent events), and reports in
``usage.prompt_tokens_details.cached_tokens`` how many prompt tokens came
from the KV cache. The number climbs every round: the growing prefix is
prefilled once.
"""

import argparse
import json
import urllib.request


def complete(base: str, prompt: str, max_tokens: int, out=print):
    """Stream one completion of ``prompt``; each text piece goes to
    ``out`` as it arrives. Returns (the reply, the usage or None)."""
    body = {"prompt": prompt, "max_tokens": max_tokens, "stream": True,
            "stream_options": {"include_usage": True}}
    req = urllib.request.Request(
        f"{base}/v1/completions", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    reply, usage = "", None
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().rstrip("\r\n")
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if ev.get("usage"):
                usage = ev["usage"]
                continue
            if not ev["choices"]:
                continue
            piece = ev["choices"][0].get("text", "")
            reply += piece
            out(piece)
    return reply, usage


def chat(base: str, lines, max_tokens: int = 24):
    """Run the conversation of ``lines``; prints as the REPL does. Returns
    [{"reply", "cached_tokens", "prompt_tokens", "ttft_ms"}] a round."""
    history, rounds = "", []
    for line in lines:
        history += ("\n" if history else "") + line
        reply, usage = complete(
            base, history, max_tokens,
            lambda piece: print(piece, end="", flush=True))
        print()
        usage = usage or {}
        cached = usage.get("prompt_tokens_details", {}).get(
            "cached_tokens", 0)
        print(f"  [cached {cached}/{usage.get('prompt_tokens')} prompt "
              f"tokens; ttft {usage.get('ttft_ms')} ms]")
        rounds.append({"reply": reply, "cached_tokens": cached,
                       "prompt_tokens": usage.get("prompt_tokens"),
                       "ttft_ms": usage.get("ttft_ms")})
        history += reply
    return rounds


def _typed_lines():
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            return
        if not line:
            return
        yield line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8377)
    ap.add_argument("--max-tokens", type=int, default=24)
    args = ap.parse_args(argv)
    print("chat client: an empty line quits")
    return chat(f"http://{args.host}:{args.port}", _typed_lines(),
                args.max_tokens)


if __name__ == "__main__":
    main()
