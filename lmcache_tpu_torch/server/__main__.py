"""CLI: ``python -m lmcache_tpu_torch.server <host> <port> [device]``.

device: "cpu" (in-memory) or a directory path (disk store).
A copy of ``lmcache_tpu/server/__main__.py`` (reference CLI parity:
lmcache/server/__main__.py:107-122); it runs with no JAX installed.
"""

import sys

from lmcache_tpu_torch.server import LMCacheServer


def main() -> None:
    if len(sys.argv) not in (3, 4):
        print("Usage: python -m lmcache_tpu_torch.server <host> <port> [device]",
              file=sys.stderr)
        sys.exit(1)
    host = sys.argv[1]
    port = int(sys.argv[2])
    device = sys.argv[3] if len(sys.argv) == 4 else "cpu"
    LMCacheServer(host, port, device).run()


if __name__ == "__main__":
    main()
