"""Where a CacheGen store's encode goes, on the card.

    python -m lmcache_tpu_torch.tools.store_split

:func:`split` runs ``CacheGenSerializer.to_bytes_batch`` once with each of
its parts timed on the host clock between two ``torch.cuda.synchronize()``:

- ``quantize``: ``quant.quantize``, both halves;
- ``cdf``: ``quant.compute_cdf``;
- ``row 12``: the encoder kernel (``range_encode.encode_streams_raw``);
- ``compaction``: ``range_encode.compact``;
- ``lengths and copy to the host``: the rest of
  ``range_encode.encode_streams``: the read of the lengths, the pinned host
  allocation and the device-to-host copy of the payload;
- ``container``: the serializer's ``_container`` (the ``b"".join``);
- ``rest``: what the total leaves (stacking, the transposing copy of the
  symbols, the maxes' and CDF tables' copies to the host).

The synchronizations make the total larger than an untimed encode's.
:func:`main` stores the KV prefix of the remote reuse phase of
``chip_smoke.py`` (tinyllama-1.1B, random weights from seed 0, 15872
tokens, 62 chunks of 256) twice, the first pass in a fresh process (cold:
PyTorch's pinned host cache is empty there), and prints one JSON line with
both splits and the card's name and power limit. It uses only names that the
package has had since the remote tier was ported, so it can time an older
tree of the package as well (put that tree first on ``PYTHONPATH`` and run
this file by its path).
"""

import json
import subprocess
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from lmcache_tpu_torch import kv
from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.ops import quant, range_encode
from lmcache_tpu_torch.storage.serde import cachegen_serde as cgs

CTX, SUFFIX, CHUNK = 15872, 512, 256
MODEL = "tinyllama-1.1b-remote"  # the tinyllama CacheGen schedule


@contextmanager
def _timing(ms):
    """Time the parts into ``ms`` (a Counter) while the block runs."""
    patched = []

    def wrap(owner, name, key):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[key] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, timed)
        patched.append((owner, name, fn))

    try:
        wrap(quant, "quantize", "quantize")
        wrap(quant, "compute_cdf", "cdf")
        wrap(range_encode, "encode_streams_raw", "row 12")
        wrap(range_encode, "compact", "compaction")
        wrap(range_encode, "encode_streams", "encode_streams")
        yield wrap
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def split(serializer, blobs):
    """{part: ms} of one ``serializer.to_bytes_batch(blobs)`` on the card,
    and the containers."""
    ms = Counter()
    with _timing(ms) as wrap:
        wrap(serializer, "_container", "container")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        containers = serializer.to_bytes_batch(blobs)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    del serializer._container  # the timer's instance attribute
    out = {k: ms[k] for k in ("quantize", "cdf", "row 12", "compaction")}
    out["lengths and copy to the host"] = (
        ms["encode_streams"] - ms["row 12"] - ms["compaction"])
    out["container"] = ms["container"]
    out["rest"] = (total - ms["quantize"] - ms["cdf"] - ms["encode_streams"]
                   - ms["container"])
    out["total"] = total
    return out, containers


def serializer():
    return cgs.CacheGenSerializer(
        LMCacheEngineConfig(local_device=None, remote_url="lm://localhost:1",
                            remote_serde="cachegen"),
        LMCacheEngineMetadata(model_name=MODEL, world_size=1, worker_id=0,
                              fmt="vllm", dtype="bfloat16"))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("store_split: needs the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = llama.LlamaConfig.tinyllama_1_1b()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, CTX + SUFFIX, dtype=np.int32)[:CTX],
        device="cuda").long()[None]
    _, cache = llama.forward(
        params, cfg, tokens, torch.zeros(1, dtype=torch.int32, device="cuda"),
        llama.new_kv_cache(cfg, 1, CTX), last_logit_only=True)
    blobs = kv.chunk_blob(llama.cache_to_blob(cache, 0, CTX), "vllm", CHUNK)
    del params, cache
    ser = serializer()
    cold, containers = split(ser, blobs)
    warm, again = split(ser, blobs)
    if again != containers:
        raise SystemExit("store_split: two encodes of one prefix differ")
    print(json.dumps({"card": card, "chunks": len(blobs),
                      "wire_bytes": sum(map(len, containers)),
                      "cold_ms": cold, "warm_ms": warm}), flush=True)


if __name__ == "__main__":
    main()
