"""Each configuration of this directory's gallery (see README.md) loaded by
``LMCacheEngineConfig.from_file`` and a store and retrieve through it.

The KV of 512 tokens of the dense examples' model (tinyllama-1.1B's
geometry in bf16 on the card, the tiny config's in fp32 on the CPU), drawn
from seed 0, is stored by one cache engine and retrieved: by the same
engine for the memory tiers, by a fresh one for the persistent ones (disk,
remote, hybrid), which then read it back from disk or the server. Every
configuration gives back the stored bits, except ``hybrid_cachegen.yaml``:
CacheGen is lossy, and its KV is held to a PSNR of at least ``PSNR_DB``.

For the run the files' settings are kept but for three: ``"cuda"`` reads as
``"cpu"`` on the CPU, the disk tier lives in a temporary directory, and
``remote_url`` names a cache server started here (or the one given).

    python -m lmcache_tpu_torch.examples.storage_backends.round_trip \\
        [--device cpu]
"""

import dataclasses
import glob
import math
import os
import sys
import tempfile

import torch

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.examples import (cache_server, check, dense_config,
                                        device_arg)
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.utils import resolve_device

HERE = os.path.dirname(os.path.abspath(__file__))
TOKENS = 512
# CacheGen's damage to Gaussian KV at its default bins is far below this
PSNR_DB = 30.0


def psnr(got: torch.Tensor, want: torch.Tensor) -> float:
    """Peak signal-to-noise ratio of ``got`` against ``want`` in dB (the
    peak is ``want``'s largest magnitude)."""
    want = want.float()
    mse = float(((got.float() - want) ** 2).mean())
    peak = float(want.abs().max())
    return float("inf") if mse == 0 else 10 * math.log10(peak * peak / mse)


def run_config(path, dev, url, disk_dir, blob, tokens, cfg):
    """Store and retrieve ``blob`` through the configuration at ``path``.
    Returns (the retrieved blob, the tokens hit)."""
    config = LMCacheEngineConfig.from_file(path)
    over = {}
    if config.local_device == "cuda" and dev.type == "cpu":
        over["local_device"] = "cpu"
    elif config.local_device not in (None, "cuda", "cpu"):
        over["local_device"] = disk_dir
    if config.remote_url is not None:
        over.update(remote_url=url, remote_device=dev.type)
    config = dataclasses.replace(config, **over)
    meta = LMCacheEngineMetadata(
        model_name=f"tinyllama-1.1b-{os.path.basename(path)}", world_size=1,
        worker_id=0, fmt="vllm", dtype=cfg.dtype)
    persistent = (config.remote_url is not None
                  or over.get("local_device") == disk_dir)
    engine = LMCacheEngine(config, meta)
    try:
        engine.store(tokens, blob)
        engine.engine_.flush()
        if persistent:
            engine.close()
            engine = LMCacheEngine(config, meta)
        got, mask = engine.retrieve(tokens, return_tuple=False)
        return got, int(mask.sum())
    finally:
        engine.close()


def main(device="cuda", url=None):
    """``url``: a running cache server (default: one started here)."""
    dev = resolve_device(device)
    if url is None:
        with cache_server() as started:
            return main(dev, started)
    cfg = dense_config(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    blob = torch.randn(cfg.n_layers, 2, TOKENS, cfg.n_kv_heads, cfg.head_dim,
                       generator=gen, device=dev).to(llama.torch_dtype(cfg))
    tokens = torch.arange(TOKENS, dtype=torch.int32).numpy()
    out = {}
    with tempfile.TemporaryDirectory() as disk_dir:
        for path in sorted(glob.glob(os.path.join(HERE, "*.yaml"))):
            name = os.path.basename(path)
            got, hit = run_config(path, dev, url, disk_dir, blob, tokens,
                                  cfg)
            exact = hit == TOKENS and torch.equal(got.to(blob.device), blob)
            db = psnr(got.to(blob.device), blob) if hit == TOKENS else None
            print(f"{name:22s} hit {hit}/{TOKENS} tokens, "
                  f"{'bit for bit' if exact else f'PSNR {db:.2f} dB'}")
            out[name] = {"hit": hit, "exact": exact, "psnr_db": db}
    for name, r in out.items():
        if name == "hybrid_cachegen.yaml":
            check(r["hit"] == TOKENS and r["psnr_db"] >= PSNR_DB,
                  f"{name} round-trips within {PSNR_DB} dB")
        else:
            check(r["exact"], f"{name} round-trips bit for bit")
    return out


if __name__ == "__main__":
    main(device_arg(sys.argv[1:]))
