"""The examples of the JAX package (``examples/``), on the port.

Each example is a module with a ``main(device="cuda", ...)`` that prints
what the JAX file prints and returns those figures as a dict. The dense
examples serve tinyllama-1.1B (bf16) on the card and ``LlamaConfig.tiny()``
(fp32) on the CPU, random weights from seed 0 (``speculative_decode`` the
trained dense quality checkpoint); ``mla_latent_cache`` serves
DeepSeek-V2-Lite at 3 of its 27 layers on the card and a tiny MLA model on
the CPU. Run one as a module:

    python -m lmcache_tpu_torch.examples.offline_inference
    python -m lmcache_tpu_torch.examples.offline_inference --device cpu

The README beside this file lists them.
"""

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import time

import torch

from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.utils import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dense_config(device) -> llama.LlamaConfig:
    """The dense examples' model on ``device``: tinyllama-1.1B on the card,
    the tiny config on the CPU."""
    if resolve_device(device).type == "cuda":
        return llama.LlamaConfig.tinyllama_1_1b()
    return llama.LlamaConfig.tiny()


def dense_model(device):
    """(:func:`dense_config`, its random weights from seed 0) on
    ``device``."""
    cfg = dense_config(device)
    return cfg, llama.init_params(cfg, device=resolve_device(device))


def check(ok: bool, claim: str) -> None:
    """Raise when the example's claim does not hold."""
    if not ok:
        raise RuntimeError(f"example failed: {claim}")


def device_arg(argv=None) -> str:
    """``--device`` of an example's command line (default "cuda")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv).device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def cache_server(timeout: float = 30.0):
    """The port's cache server (``python -m lmcache_tpu_torch.server``, CPU
    storage) in a subprocess on a free port while entered; yields its
    ``lm://`` URL and stops it on exit."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen([sys.executable, "-m", "lmcache_tpu_torch.server",
                             "localhost", str(port), "cpu"], env=env)
    try:
        deadline = time.time() + timeout
        while True:
            try:
                socket.create_connection(("localhost", port),
                                         timeout=0.5).close()
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise RuntimeError(
                        f"the cache server did not answer in {timeout} s")
                time.sleep(0.05)
        yield f"lm://localhost:{port}"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
