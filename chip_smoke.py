#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lmcache_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the package from its sources (one ``nvcc``
   per source, all at once) and print the build time and nvcc's report;
2. hold each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the main path gives it;
3. the main path at full width, tinyllama-1.1B with random weights from a
   seeded generator: full prefill of CTX + SUFFIX = 16384 tokens, store of
   the CTX prefix into the "cuda" cache tier, retrieve (15872 hits), inject,
   suffix prefill; the reuse logits must agree with the full prefill's; TTFT
   full and reuse (best of 3 after a warm-up); one ``torch.profiler``
   window over each (device idle share, the kernels that take the time);
4. serving: a ``ServingEngine`` answers four waves of greedy prompts; a
   repeated wave must hit the cache and give the same tokens, and a
   suffix prefilled over an injected prefix must agree with an engine
   that has no cache tier (``phase_serving``);
5. the launch counts of phases 3 and 4 (prefill and decode, each > 0);
6. the yardstick: each kernel's time at phase 2's shapes beside its bound,
   its plain version and one PyTorch library call.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without printing a result
when CUDA is unavailable or the package is missing.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch import ops
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.serving import SamplingParams, ServingEngine

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# kernel vs plain version in bf16: the plain version keeps P in fp32 and
# rounds once at the end, the kernel rounds P to bf16 before PV (as the TPU
# kernel does) and sums in another order, so an output may land one bf16
# ulp away: |out - ref| <= ATOL + RTOL * |ref| elementwise (one ulp is at
# most 2**-7 of the value), and the relative L2 error within REL_L2
ATOL_KERNEL = 2e-2
RTOL_KERNEL = 2.0**-7
REL_L2_KERNEL = 1e-2
# reuse vs full prefill logits: bf16 activations through 22 layers, suffix
# rows computed in GEMMs of other shapes
REL_L2_REUSE = 5e-2

CTX, SUFFIX = 15872, 512


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls
    (CUDA events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_best(fn, n=3):
    """Best host time in ms of ``fn`` (ending in a synchronize) over ``n``
    runs after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


# ---------------------------------------------------------------- phase 2 ---

SERVE_S = 2048 + 64 + 1  # phase 4's pool: max_seq + one parking position


def attention_cases():
    """(name, B, T, H, H_kv, D, S, q_offset, kv_len): the shapes the main
    path gives the kernel, tinyllama (H 32, H_kv 4, D 64): phase 3's suffix
    prefill over the 15872 cached tokens and its 16384-token full prefill,
    phase 4's 512-token prefill segments (from scratch, or over 1536
    injected tokens) and its batched decode with one parked row; then a 2048-token prefill, ragged decode over up to 16k
    tokens, and one llama-2-7b geometry (H = H_kv = 32, D 128)."""
    return [
        ("tinyllama suffix prefill", 1, 512, 32, 4, 64, 16384, [CTX],
         [CTX + SUFFIX]),
        ("tinyllama full prefill 16k", 1, CTX + SUFFIX, 32, 4, 64,
         CTX + SUFFIX, [0], [CTX + SUFFIX]),
        ("tinyllama serving prefill segment", 1, 512, 32, 4, 64, SERVE_S,
         [1024], [1536]),
        ("tinyllama serving decode", 4, 1, 32, 4, 64, SERVE_S,
         [2080, 2060, 2100, SERVE_S - 1], [2081, 2061, 2101, SERVE_S]),
        ("tinyllama full prefill 2k", 1, 2048, 32, 4, 64, 2048, [0],
         [2048]),
        ("tinyllama decode 16k", 4, 1, 32, 4, 64, 16385,
         [16383, 9000, 3000, 0], [16384, 9001, 3001, 1]),
        ("llama-2-7b suffix prefill", 1, 512, 32, 32, 128, 4096, [3584],
         [4096]),
        ("llama-2-7b decode", 4, 1, 32, 32, 128, 4097,
         [4095, 2000, 700, 4096], [4096, 2001, 701, 4097]),
    ]


def make_attention_inputs(case, gen):
    name, B, T, H, Hkv, D, S, q_off, kv_len = case
    dev = "cuda"
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    # head-major pool rows, as the model passes them
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).bfloat16()
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, qo, kl


def plain_attention(q, k, v, qo, kl, rows=1024):
    """The kernel's plain version (``mha_reference``) on head-major K/V,
    over at most ``rows`` queries per call, so that the score matrix of a
    16k-token prefill fits in memory."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    T = q.shape[1]
    return torch.cat([
        ops.mha_reference(q[:, t:t + rows], kt, vt, qo + t, kl)
        for t in range(0, T, rows)], dim=1)


def attention_bound(case):
    """Least time (ms) for the work these inputs need: every live (query,
    key) pair costs 4*D operations per query head; bytes are q and out
    once, plus the live K/V rows once."""
    name, B, T, H, Hkv, D, S, q_off, kv_len = case
    pairs = 0
    kv_rows = 0
    for b in range(B):
        lim = np.minimum(q_off[b] + np.arange(T), kv_len[b] - 1) + 1
        pairs += int(lim.sum())
        kv_rows += int(min(q_off[b] + T, kv_len[b]))
    flops = 4.0 * D * H * pairs
    nbytes = 2 * (2 * B * T * H * D + 2 * kv_rows * Hkv * D)
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def phase_kernels():
    log("== phase 2: kernels vs plain versions (bf16, on the card)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for case in attention_cases():
        q, k, v, qo, kl = make_attention_inputs(case, gen)
        out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
        ref = plain_attention(q, k, v, qo, kl).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        max_abs = diff.max().item()
        excess = (diff - RTOL_KERNEL * ref.abs()).max().item()
        rel = (diff.norm() / ref.norm()).item()
        ok = (bool(torch.isfinite(out.float()).all())
              and excess <= ATOL_KERNEL and rel <= REL_L2_KERNEL)
        log(f"  {case[0]}: out {tuple(out.shape)} max_abs_err {max_abs:.3e} "
            f"rel_l2 {rel:.3e} (tolerance |err| <= {ATOL_KERNEL} + "
            f"{RTOL_KERNEL:.4f}|ref|, rel_l2 <= {REL_L2_KERNEL}) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees at {case[0]}")
        worst = max(worst, max_abs)
        del q, k, v, out, ref, diff
    return worst


# ---------------------------------------------------------------- phase 3 ---

def phase_main_path(cfg, params):
    log("== phase 3: tinyllama-1.1B prefill -> store -> retrieve -> inject "
        "-> suffix prefill")
    S = CTX + SUFFIX
    rng = np.random.default_rng(0)
    tokens_np = rng.integers(0, cfg.vocab_size, S, dtype=np.int32)
    tokens = torch.as_tensor(tokens_np, device="cuda").long()[None]
    engine = LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name="tinyllama-1.1b", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))

    def prefill_full():
        cache = llama.new_kv_cache(cfg, 1, S)
        logits, cache = llama.forward(
            params, cfg, tokens, torch.zeros(1, dtype=torch.int32,
                                             device="cuda"),
            cache, last_logit_only=True)
        return logits[0, -1], cache

    def prefill_reuse():
        blob, mask = engine.retrieve(tokens_np, return_tuple=False)
        if int(mask.sum()) != CTX:
            raise SystemExit(f"expected {CTX} hits, got {int(mask.sum())}")
        cache = llama.blob_into_cache(llama.new_kv_cache(cfg, 1, S), blob)
        logits, _ = llama.forward(
            params, cfg, tokens[:, CTX:],
            torch.full((1,), CTX, dtype=torch.int32, device="cuda"), cache,
            last_logit_only=True)
        return logits[0, -1]

    full_logits, cache = prefill_full()
    n_chunks = engine.store(tokens_np[:CTX],
                            llama.cache_to_blob(cache, 0, CTX))
    del cache
    reuse_logits = prefill_reuse()
    torch.cuda.synchronize()
    rel = ((reuse_logits - full_logits).norm() / full_logits.norm()).item()
    top_full = int(full_logits.argmax())
    top_reuse = int(reuse_logits.argmax())
    finite = bool(torch.isfinite(full_logits).all()
                  and torch.isfinite(reuse_logits).all())
    log(f"  stored {n_chunks} chunks; logits {tuple(full_logits.shape)} "
        f"finite {finite}; top-1 full {top_full} reuse {top_reuse}; "
        f"rel_l2 {rel:.3e} (tolerance {REL_L2_REUSE})")
    if not (finite and top_full == top_reuse and rel <= REL_L2_REUSE):
        raise SystemExit("reuse logits disagree with the full prefill")

    t_full = wall_best(lambda: prefill_full())
    t_reuse = wall_best(prefill_reuse)
    log(f"  TTFT full {t_full:.2f} ms, TTFT reuse {t_reuse:.2f} ms, "
        f"ratio {t_full / t_reuse:.2f}x (best of 3 after a warm-up)")
    profile = [profile_window("full prefill", lambda: prefill_full()),
               profile_window("reuse request", prefill_reuse)]
    engine.close()
    return {"ttft_full_ms": t_full, "ttft_reuse_ms": t_reuse,
            "speedup": t_full / t_reuse, "profile": profile}


def profile_window(name, fn, top=5):
    """One warm run of ``fn`` under ``torch.profiler``: host time, summed
    kernel time, device idle share (1 - kernel / host time; one stream, so
    kernels do not overlap) and the kernels that took the most time. Host
    time includes the profiler's own overhead."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the GPU-side copies of the package's
    # record_function ranges
    by_time = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.key.startswith("lmcache_tpu_torch::")), reverse=True)
    device_ms = sum(ms for ms, _, _ in by_time)
    if device_ms <= 0:
        log(f"  profile {name}: host {host_ms:.3f} ms, device time not "
            f"recorded by the profiler")
        return {"window": name, "host_ms": host_ms, "device_ms": None}
    idle = 1 - device_ms / host_ms
    log(f"  profile {name}: host {host_ms:.3f} ms, device {device_ms:.3f} ms, "
        f"idle share {idle:.4f}")
    for ms, count, key in by_time[:top]:
        log(f"    {ms:10.3f} ms {100 * ms / host_ms:6.2f} %  x{count:<5d} "
            f"{key[:90]}")
    return {"window": name, "host_ms": host_ms, "device_ms": device_ms,
            "idle_share": idle,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in by_time[:top]]}


# ---------------------------------------------------------------- phase 4 ---

def _first_diverging(a, b):
    """Per request pair, the index of the first differing output token,
    or None."""
    return [next((i for i, (x, y) in enumerate(
        zip(r.output_tokens, s.output_tokens)) if x != y), None)
        for r, s in zip(a, b)]


def _logits_agree(name, got, want):
    """Same top-1 and relative L2 within REL_L2_REUSE, per request."""
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    same_top = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    ok = all(same_top) and max(rel) <= REL_L2_REUSE
    log(f"  {name}: first-token logits rel_l2 "
        f"{[f'{r:.3e}' for r in rel]} same top-1 {same_top} (tolerance "
        f"{REL_L2_REUSE}) {'ok' if ok else 'FAILED'}")
    return ok


def phase_serving(cfg, params):
    """Greedy requests, 32 new tokens each, served in 512-token prefill
    segments by an engine with a "cuda" cache tier.

    - Waves 1 and 2: the same three 2049-token prompts, two of them sharing
      a 1536-token prefix. The last prompt token is prefilled alone in both
      waves (in wave 2 it is the one token left after the cache hit), so
      every matrix product of wave 2 has its wave-1 shape: bf16 greedy
      tokens must match exactly.
    - Wave 3: two new 2048-token prompts on the shared prefix. They hit its
      1536 cached tokens and prefill a 512-token suffix over the injected
      KV; an engine with no cache tier, which computes the prefix in the
      same segments, must give the same tokens.
    - Wave 4: wave 3's prompts again. 2047 tokens hit and the last one is
      prefilled alone, where wave 3 computed it in a 512-row segment. bf16
      rounds differently there, so the first-token logits are held to the
      reuse tolerance and the greedy tokens are reported, not compared.
    """
    log("== phase 4: ServingEngine, four waves")
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, V, 1536)
    repeat = [np.concatenate([prefix, rng.integers(0, V, 513)]),
              np.concatenate([prefix, rng.integers(0, V, 513)]),
              rng.integers(0, V, 2049)]
    fresh = [np.concatenate([prefix, rng.integers(0, V, 512)])
             for _ in range(2)]
    sp = SamplingParams(max_new_tokens=32)
    engine = LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name="tinyllama-1.1b", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))

    def serving_engine(cache_engine):
        # one 512-token segment per request per step
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=2048 + 64,
                            cache_engine=cache_engine, prefill_chunk=512,
                            prefill_token_budget=3 * 512)
        # keep each request's first-token logits (the end of its prefill)
        eng.first_logits = {}
        finish = eng._finish_prefill

        def finish_and_keep(req, logits):
            eng.first_logits[req.request_id] = logits.float().clone()
            finish(req, logits)
        eng._finish_prefill = finish_and_keep
        return eng

    def wave(eng, name, prompts):
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if eng.cache_engine is not None:
            eng.cache_engine.engine_.flush()
        first = min(r.arrival_s + r.ttft_s for r in reqs)
        last = max(r.finish_s for r in reqs)
        n_dec = sum(len(r.output_tokens) - 1 for r in reqs)
        log(f"  {name}: TTFT ms {[round(r.ttft_s * 1e3, 2) for r in reqs]} "
            f"cached_prefix_len {[r.cached_prefix_len for r in reqs]} "
            f"decode {n_dec / (last - first):.1f} tok/s, wall {wall:.2f} s")
        return reqs, [eng.first_logits[r.request_id] for r in reqs]

    eng = serving_engine(engine)
    w1, _ = wave(eng, "wave 1", repeat)
    w2, _ = wave(eng, "wave 2", repeat)
    w3, l3 = wave(eng, "wave 3", fresh)
    w4, l4 = wave(eng, "wave 4", fresh)
    engine.close()
    ref, l_ref = wave(serving_engine(None), "wave 3 without a cache tier",
                      fresh)

    failed = []
    d12 = _first_diverging(w1, w2)
    log(f"  wave 2: first differing token vs wave 1 {d12}")
    if not (all(r.cached_prefix_len > 0 for r in w2)
            and d12 == [None] * len(w2)):
        failed.append("wave 2 missed the cache or changed greedy tokens")
    d3 = _first_diverging(w3, ref)
    log(f"  wave 3: first differing token vs the engine without a cache "
        f"tier {d3}")
    if not ([r.cached_prefix_len for r in w3] == [len(prefix)] * len(w3)
            and d3 == [None] * len(w3)
            and _logits_agree("wave 3 vs no cache tier", l3, l_ref)):
        failed.append("wave 3's suffix prefill over the injected prefix "
                      "disagrees with the uncached engine")
    log(f"  wave 4: first differing token vs wave 3 "
        f"{_first_diverging(w4, w3)} (reported, not compared)")
    if not (all(r.cached_prefix_len == len(p) - 1 for r, p in zip(w4, fresh))
            and _logits_agree("wave 4 vs wave 3", l4, l3)):
        failed.append("wave 4 missed the cache or its logits disagree")
    if failed:
        raise SystemExit("; ".join(failed))


# ---------------------------------------------------------------- phase 6 ---

def phase_yardstick():
    log("== phase 6: kernel time vs bound, plain version and SDPA")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case in attention_cases():
        name, B, T, H, Hkv, D, S, q_off, kv_len = case
        q, k, v, qo, kl = make_attention_inputs(case, gen)
        decode = T == 1
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, qo, kl,
                                                 kv_head_major=True),
                     iters=200 if decode else 20)
        plain_ms = cuda_ms(lambda: plain_attention(q, k, v, qo, kl),
                           iters=3, warmup=1)
        # one library call for the same function: SDPA, causal where the
        # mask is plain causal, else with the same mask
        qh = q.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if T == S and max(q_off) == 0 and min(kv_len) == S:
            mask_kw = {"is_causal": True}
        else:
            kpos = torch.arange(S, device="cuda")
            qpos = qo[:, None] + torch.arange(T, device="cuda")[None]
            mask_kw = {"attn_mask": (
                (kpos[None, None] <= qpos[:, :, None])
                & (kpos[None, None] < kl[:, None, None]))[:, None]}
        library_ms = cuda_ms(lambda: sdpa(qh, k, v, enable_gqa=True,
                                          **mask_kw),
                             iters=200 if decode else 20)
        bound_ms, bound_by = attention_bound(case)
        row = {"shape": name, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        log(f"  {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), plain {plain_ms:.4f} ms, SDPA "
            f"{library_ms:.4f} ms")
        rows.append(row)
        del q, k, v, qh, mask_kw
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("== phase 1: build")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")

    max_abs = phase_kernels()

    cfg = llama.LlamaConfig.tinyllama_1_1b()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))

    launches = {}
    ops.flash_attention.launches.clear()
    ttft = phase_main_path(cfg, params)
    launches["main_path"] = dict(ops.flash_attention.launches)
    ops.flash_attention.launches.clear()
    phase_serving(cfg, params)
    launches["serving"] = dict(ops.flash_attention.launches)

    log("== phase 5: launch counts")
    log(f"  flash_attention launches {launches}")
    for phase, by_kind in launches.items():
        for kind in ("prefill", "decode") if phase == "serving" else (
                "prefill",):
            if by_kind.get(kind, 0) <= 0:
                raise SystemExit(f"flash_attention: no {kind} launch in "
                                 f"{phase}")
    del params
    torch.cuda.empty_cache()

    rows = phase_yardstick()
    head = rows[0]  # the bench shape: suffix prefill over the cached prefix
    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "lmcache_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "lmcache_tpu/ops/attention.py:110",
        "launches": sum(sum(v.values()) for v in launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": max_abs,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": rows,
    }], "ttft": ttft, "card": card}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
