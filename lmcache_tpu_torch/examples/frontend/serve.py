"""Serve the browser chat UI and proxy /v1/* to the API server (a copy of
the JAX package's ``examples/frontend/serve.py``).

Counterpart of the reference's streamlit frontend (reference
examples/frontend/frontend.py) as a dependency-free stdlib server: the
page is static HTML/JS (frontend.html) and this process forwards its
API calls to the lmcache-tpu OpenAI server so the browser needs no CORS
configuration.

Start an API server first (``online_session.py --serve`` serves one),
then

    python -m lmcache_tpu_torch.examples.frontend.serve --api-port 8377 \
        --port 8380

and open http://localhost:8380/.
"""

import argparse
import http.server
import json
import os
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))


def make_handler(api_base: str):

    class Handler(http.server.BaseHTTPRequestHandler):

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html", "/frontend.html"):
                with open(os.path.join(HERE, "frontend.html"), "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path.startswith("/v1/") or self.path == "/health":
                self._proxy("GET", None)
                return
            self.send_error(404)

        def do_POST(self):
            if not self.path.startswith("/v1/"):
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            self._proxy("POST", self.rfile.read(n))

        def _proxy(self, method, body):
            req = urllib.request.Request(
                api_base + self.path, data=body, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as up:
                    self.send_response(up.status)
                    ctype = up.headers.get("Content-Type",
                                           "application/json")
                    self.send_header("Content-Type", ctype)
                    self.end_headers()
                    # stream SSE frames through as they arrive
                    while True:
                        chunk = up.read(4096)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
            except urllib.error.HTTPError as e:
                payload = e.read()
                self.send_response(e.code)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(payload or json.dumps(
                    {"error": str(e)}).encode())
            except OSError as e:
                self.send_response(502)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(
                    {"error": f"API server unreachable: {e}"}).encode())

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8380)
    ap.add_argument("--api-host", default="localhost")
    ap.add_argument("--api-port", type=int, default=8377)
    args = ap.parse_args(argv)
    api = f"http://{args.api_host}:{args.api_port}"
    srv = http.server.ThreadingHTTPServer(
        (args.host, args.port), make_handler(api))
    print(f"frontend on http://{args.host}:{args.port}/ "
          f"(proxying {api})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
