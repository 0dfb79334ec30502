#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lmcache_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the package from its sources (one ``nvcc``
   per source, all at once) and print the build time and nvcc's report;
2. hold each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the paths below give it: ``flash_attention`` (plain
   and with each option: sliding and chunked window, softcap, sinks,
   ``kv_slot``, at the public shapes of Mistral, Phi-3, Gemma-2, GPT-OSS and
   Llama-4), ``flash_attention_dma``, ``quantized_flash_attention`` (plain
   and with the same options) and the four paged-attention kernels (bf16
   and int8 arenas);
3. the dense main path at full width, tinyllama-1.1B with random weights
   from a seeded generator: full prefill of CTX + SUFFIX = 16384 tokens,
   store of the CTX prefix into the "cuda" cache tier, retrieve (15872
   hits), inject, suffix prefill; the reuse logits must agree with the full
   prefill's; TTFT full and reuse (best of 3 after a warm-up); one
   ``torch.profiler`` window over each (device idle share, the kernels
   that take the time);
4. dense serving: a ``ServingEngine`` answers four waves of greedy prompts;
   a repeated wave must hit the cache and give the same tokens, and a
   suffix prefilled over an injected prefix must agree with an engine
   that has no cache tier (``phase_serving``);
5. paged serving, path A: a ``PagedServingEngine`` over a bf16 and then an
   int8 page arena, tinyllama-1.1B (head dim 64: the streaming kernels),
   four waves: fresh prompts against the dense engine's logits, the same
   prompts served from resident pages, a fresh engine served by retrieve +
   page injection, and an arena so small that decode growth preempts a
   request, which resumes and finishes; one ``torch.profiler`` window over
   a batched decode step (``phase_paged_tinyllama``);
6. paged serving, path B: Phi-3-mini-4k at full width and depth (head dim
   96, sliding window 2047: the one-page-per-step kernels), two prompts of
   about 3000 tokens over a bf16 and then an int8 arena; the logits of the
   last prompt token are held against ``forward_paged*`` run with the plain
   attention on the same arena (``phase_paged_phi3``);
6c. path C, the dense int8 pool on tinyllama-1.1B: the bench shape of
   phase 3 through ``forward_quantized`` (TTFT full, reuse and ratio; the
   reuse logits held to the full prefill's as in phase 3; the pool stored
   back dequantized and injected again must come back symbol for symbol)
   and the four waves of phase 4 with ``kv_dtype="int8"``, held as the
   native pool's are, first-token logits also held to the native engine's;
   one ``torch.profiler`` window over a batched decode step
   (``phase_int8_dense``);
6d. path D, windowed dense attention: a ``ServingEngine`` on Mistral-7B at
   full width and depth (window 4096), two prompts of about 6000 tokens, 16
   new tokens, over the native and then the int8 pool (the timed pass);
   the prompts are then served again and the logits of the last prompt
   token held against the same forward run with the plain attention on the
   same pool; one ``torch.profiler`` window over a prefill segment past the
   window (``phase_mistral``);
6e. the streamed prefill kernel, which no serving path calls: phase 3's full
   prefill once more with the model's attention bound to
   ``flash_attention_dma`` here, logits held to ``flash_attention``'s
   (``phase_streamed_prefill``);
7. the launch counts of phases 3 to 6e, read per phase with every count set
   to 0 just before it (prefill and decode, each > 0 where the phase runs
   them; "+window" marks launches under a window);
8. the yardstick: each kernel's time at phase 2's shapes beside its bound,
   its plain version and a PyTorch library time (SDPA; for a paged arena
   the gather of the live pages into dense K/V, then SDPA; for int8 K/V the
   dequantization to bf16, then SDPA; none where softcap or sinks leave no
   single call).

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
from lmcache_tpu_torch.ops import paged_attention as pa
from lmcache_tpu_torch.ops import quantized_attention as qa
from lmcache_tpu_torch.serving import (PagedServingEngine, Request,
                                       SamplingParams, ServingEngine)

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
# Mistral-7B's random weights give nearly flat logits, and two forwards that
# agree within REL_L2_REUSE differ by about that share of the logits' rms in
# every element: there the kernel path may put first a token that the plain
# path puts within twice that share of its own best logit. A wrong token lies
# an ordinary logit's distance, several rms, below the best
TOP1_MARGIN = 2 * REL_L2_REUSE
# first-token logits over an int8 page arena against the bf16 arena's: K and
# V carry one symmetric int8 rounding per token (half a step of absmax / 127
# over the token's heads and channels), through every layer
REL_L2_INT8 = 1e-1

CTX, SUFFIX = 15872, 512
PAGE = 64  # page size of both paged paths

# the port's kernels: name -> (wrapper, source, TPU kernel it replaces)
KERNELS = {
    "flash_attention": (
        ops.flash_attention, "lmcache_tpu_torch/ops/csrc/flash_attention.cu",
        "lmcache_tpu/ops/attention.py:110"),
    "flash_attention_dma": (
        ops.flash_attention_dma,
        "lmcache_tpu_torch/ops/csrc/flash_stream_attention.cu",
        "lmcache_tpu/ops/attention.py:398"),
    "quantized_flash_attention": (
        qa.quantized_flash_attention,
        "lmcache_tpu_torch/ops/csrc/quantized_flash_attention.cu",
        "lmcache_tpu/ops/quantized_attention.py:67"),
    "paged_attention": (
        pa.paged_attention, "lmcache_tpu_torch/ops/csrc/paged_attention.cu",
        "lmcache_tpu/ops/paged_attention.py:171"),
    "quantized_paged_attention": (
        pa.quantized_paged_attention,
        "lmcache_tpu_torch/ops/csrc/paged_attention.cu",
        "lmcache_tpu/ops/paged_attention.py:182"),
    "paged_attention_dma": (
        pa.paged_attention_dma,
        "lmcache_tpu_torch/ops/csrc/paged_stream_attention.cu",
        "lmcache_tpu/ops/paged_attention.py:583"),
    "quantized_paged_attention_dma": (
        pa.quantized_paged_attention_dma,
        "lmcache_tpu_torch/ops/csrc/paged_stream_attention.cu",
        "lmcache_tpu/ops/paged_attention.py:885"),
}


def reset_launch_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches.clear()


def read_launch_counts():
    """{kernel: {"prefill": n, "decode": m}} of the kernels launched since
    the last reset."""
    return {name: dict(wrapper.launches)
            for name, (wrapper, _, _) in KERNELS.items() if wrapper.launches}


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
    injected tokens) and its batched decode with one parked row; then a
    2048-token prefill, ragged decode over up to 16k tokens, and one
    llama-2-7b geometry (H = H_kv = 32, D 128)."""
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


def hold_against_plain(kernel, case_name, out, ref):
    """Max abs error of a kernel's output against its plain version's;
    exits when it is outside the stated tolerance."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    max_abs = diff.max().item()
    excess = (diff - RTOL_KERNEL * ref.abs()).max().item()
    rel = (diff.norm() / ref.norm()).item()
    ok = (bool(torch.isfinite(out.float()).all())
          and excess <= ATOL_KERNEL and rel <= REL_L2_KERNEL)
    log(f"  {kernel} | {case_name}: out {tuple(out.shape)} max_abs_err "
        f"{max_abs:.3e} rel_l2 {rel:.3e} (tolerance |err| <= {ATOL_KERNEL} "
        f"+ {RTOL_KERNEL:.4f}|ref|, rel_l2 <= {REL_L2_KERNEL}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{kernel} disagrees with its plain version at "
                         f"{case_name}")
    return max_abs


def phase_kernels():
    """{kernel: worst max abs error over its cases}."""
    log("== phase 2: kernels vs plain versions (bf16, on the card)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in KERNELS}
    for case in attention_cases():
        q, k, v, qo, kl = make_attention_inputs(case, gen)
        out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
        ref = plain_attention(q, k, v, qo, kl)
        torch.cuda.synchronize()
        worst["flash_attention"] = max(
            worst["flash_attention"],
            hold_against_plain("flash_attention", case[0], out, ref))
        del q, k, v, out, ref
    for case in dense_cases():
        q, kv, qo, kl, kw = make_dense_inputs(case, gen)
        out = dense_call(case, q, kv, qo, kl, kw)
        ref = dense_plain(case, q, kv, qo, kl, kw)
        torch.cuda.synchronize()
        worst[case["kernel"]] = max(
            worst[case["kernel"]],
            hold_against_plain(case["kernel"], case["name"], out, ref))
        del q, kv, out, ref
    for case in paged_cases():
        args, kw = make_paged_inputs(case, gen)
        out = KERNELS[case["kernel"]][0](*args, **kw)
        ref = paged_plain(case)(*args, **kw)
        torch.cuda.synchronize()
        worst[case["kernel"]] = max(
            worst[case["kernel"]],
            hold_against_plain(case["kernel"], case["name"], out, ref))
        del args, out, ref
    return worst


# ------------------------- rows 1 (options), 2 and 3: the dense kernels ---

MISTRAL_SEQ = 8192  # path D's max_seq; the pool has one parking position
MISTRAL_PROMPTS = (6000, 5987)


def dense_cases():
    """The shapes paths C and D give the dense kernels, and each option at
    the public shape of a model that uses it. Keys: the kernel, B, T, H,
    H_kv, D, S, q_off, kv_len, and the options ``window`` with ``kind``,
    ``softcap``, ``sinks``, ``sm_scale``, and ``pool_rows`` with ``slot``
    (K/V carry a pool of that many rows, read at row ``slot``). The first
    case of a kernel is the one its path gives it first."""
    off = dict(window=None, kind="sliding", softcap=None, sinks=False,
               sm_scale=None, pool_rows=None, slot=None)
    tiny = dict(H=32, Hkv=4, D=64)
    mistral = dict(H=32, Hkv=8, D=128, window=4096, S=MISTRAL_SEQ + 1)
    cases = []

    def add(kernels, name, **kw):
        kw.setdefault("kv_len", [o + kw["T"] for o in kw["q_off"]])
        cases.extend(dict(off, name=name, kernel=k, **kw) for k in kernels)

    flash = ("flash_attention",)
    stream = ("flash_attention_dma",)
    quant = ("quantized_flash_attention",)
    # row 2, where a prefill is large; the first is phase 6e's shape
    add(stream, "tinyllama full prefill 16k", B=1, T=CTX + SUFFIX,
        S=CTX + SUFFIX, q_off=[0], **tiny)
    add(stream, "tinyllama suffix prefill", B=1, T=512, S=16384,
        q_off=[CTX], **tiny)
    add(stream, "tinyllama serving prefill segment", B=1, T=512, S=SERVE_S,
        q_off=[1024], **tiny)
    add(stream, "llama-2-7b suffix prefill", B=1, T=512, H=32, Hkv=32, D=128,
        S=4096, q_off=[3584])
    add(stream, "phi3 geometry, 2048 from 0", B=1, T=2048, H=32, Hkv=32,
        D=96, S=2048, q_off=[0])
    # row 3 on path C, tinyllama: phase 3's and phase 4's shapes
    add(quant, "tinyllama suffix prefill", B=1, T=512, S=16384, q_off=[CTX],
        **tiny)
    add(quant, "tinyllama full prefill 16k", B=1, T=CTX + SUFFIX,
        S=CTX + SUFFIX, q_off=[0], **tiny)
    add(quant, "tinyllama serving prefill segment", B=1, T=512, S=SERVE_S,
        q_off=[1024], **tiny)
    add(quant, "tinyllama serving decode", B=4, T=1, S=SERVE_S,
        q_off=[2080, 2060, 2100, SERVE_S - 1], **tiny)
    add(quant, "tinyllama decode 16k", B=4, T=1, S=16385,
        q_off=[16383, 9000, 3000, 0], **tiny)
    # rows 1 and 3 on path D, Mistral-7B: a segment past the window, the
    # last segment of a prompt, decode with both rows live
    both = flash + quant
    add(both, "mistral prefill segment past the window", B=1, T=512,
        q_off=[5120], **mistral)
    add(both, "mistral last prompt segment", B=1,
        T=MISTRAL_PROMPTS[0] - 5632, q_off=[5632], **mistral)
    add(both, "mistral decode", B=2, T=1, q_off=[6005, 5995], **mistral)
    # the other options, each at the public shape of a model that has it
    add(both, "phi3 (D 96, window 2047)", B=1, T=512, H=32, Hkv=32, D=96,
        S=4097, q_off=[2560], window=2047)
    add(both, "gemma-2 (D 256, softcap 50, window 4096)", B=1, T=512, H=16,
        Hkv=8, D=256, S=8192, q_off=[5000], window=4096, softcap=50.0,
        sm_scale=256.0**-0.5)
    add(both, "gemma-2 decode, global layer (softcap 50)", B=2, T=1, H=16,
        Hkv=8, D=256, S=8192, q_off=[8000, 3000], softcap=50.0,
        sm_scale=256.0**-0.5)
    add(both, "gpt-oss (sinks, window 128)", B=1, T=512, H=64, Hkv=8, D=64,
        S=4096, q_off=[2000], window=128, sinks=True)
    add(both, "gpt-oss decode, global layer (sinks)", B=2, T=1, H=64, Hkv=8,
        D=64, S=4096, q_off=[4000, 17], sinks=True)
    # a block of 64 rows spans 64 / 5 tokens: the one that holds position
    # 8192 straddles the chunk boundary
    add(both, "llama-4 (chunk 8192, a block across the boundary)", B=1,
        T=512, H=40, Hkv=8, D=128, S=16384, q_off=[8001], window=8192,
        kind="chunked")
    add(both, "llama-4 decode (chunk 8192)", B=2, T=1, H=40, Hkv=8, D=128,
        S=16384, q_off=[8191, 8192], window=8192, kind="chunked")
    add(both, "tinyllama prefill segment, kv_slot 2 of a 4-row pool", B=1,
        T=512, S=SERVE_S, q_off=[1024], pool_rows=4, slot=2, **tiny)
    return cases


def make_dense_inputs(case, gen):
    """(q, K/V tensors, q_offset, kv_len, options) of a dense case, K/V
    head-major as the model passes them: (k, v) in bf16, or for the int8
    kernel (k_sym, v_sym, k_scale, v_scale)."""
    dev = "cuda"
    B, T, H, Hkv, D, S = (case[k] for k in ("B", "T", "H", "Hkv", "D", "S"))
    rows = case["pool_rows"] or B
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    if case["kernel"] == "quantized_flash_attention":
        sym = torch.randint(-127, 128, (2, rows, Hkv, S, D), generator=gen,
                            device=dev, dtype=torch.int32).to(torch.int8)
        # scales of unit-variance tokens: absmax / 127 is about 0.03
        scale = (torch.rand((2, rows, S), generator=gen, device=dev) * 0.02
                 + 0.02)
        kv = (sym[0], sym[1], scale[0], scale[1])
    else:
        x = torch.randn((2, rows, Hkv, S, D), generator=gen,
                        device=dev).bfloat16()
        kv = (x[0], x[1])
    qo = torch.tensor(case["q_off"], dtype=torch.int32, device=dev)
    kl = torch.tensor(case["kv_len"], dtype=torch.int32, device=dev)
    kw = dict(sm_scale=case["sm_scale"])
    if case["kernel"] != "flash_attention_dma":
        kw.update(sliding_window=case["window"], window_kind=case["kind"],
                  logit_softcap=case["softcap"])
        if case["sinks"]:
            kw["sinks"] = torch.randn(H, generator=gen, device=dev) * 3.0
        if case["slot"] is not None:
            kw["kv_slot"] = torch.tensor([case["slot"]], dtype=torch.int32,
                                         device=dev)
    return q, kv, qo, kl, kw


def dense_call(case, q, kv, qo, kl, kw):
    if case["kernel"] == "flash_attention_dma":
        return ops.flash_attention_dma(q, *kv, qo, kl, **kw)
    return KERNELS[case["kernel"]][0](q, *kv, qo, kl, kv_head_major=True,
                                      **kw)


def dense_plain(case, q, kv, qo, kl, kw, rows=1024):
    """The case's plain version (``mha_reference`` or
    ``quantized_attention_reference``, token-major) over at most ``rows``
    queries per call."""
    kw = {k: v for k, v in kw.items() if k != "kv_slot"}
    if case["slot"] is not None:
        kv = [t[case["slot"]:case["slot"] + 1] for t in kv]
    kv = [t.transpose(1, 2) if t.dim() == 4 else t for t in kv]
    plain = (qa.quantized_attention_reference if len(kv) == 4
             else ops.mha_reference)
    return torch.cat([
        plain(q[:, t:t + rows], *kv, qo + t, kl, zero_dead_rows=True, **kw)
        for t in range(0, q.shape[1], rows)], dim=1)


def dense_bound(case):
    """Least time (ms) for the work these inputs need: 4*D operations per
    live (query, key) pair and query head (live: under the causal limit,
    kv_len and the window); bytes are q and out once, the K/V rows between
    the oldest and the newest live key once (int8: one byte each, plus the
    two fp32 scales per row)."""
    B, T, H, Hkv, D = (case[k] for k in ("B", "T", "H", "Hkv", "D"))
    W = case["window"]
    quant = case["kernel"] == "quantized_flash_attention"
    pairs = kv_rows = 0
    for q_off, kv_len in zip(case["q_off"], case["kv_len"]):
        qpos = q_off + np.arange(T)
        hi = np.minimum(qpos, kv_len - 1)
        if not W:
            lo = np.zeros_like(qpos)
        elif case["kind"] == "chunked":
            lo = qpos // W * W
        else:
            lo = np.maximum(qpos - W + 1, 0)
        pairs += int(np.maximum(hi - lo + 1, 0).sum())
        if hi.max() >= lo.min():
            kv_rows += int(hi.max() - lo.min() + 1)
    flops = 4.0 * D * H * pairs
    kv_bytes = 2 * kv_rows * Hkv * D * (1 if quant else 2)
    if quant:
        kv_bytes += 2 * kv_rows * 4
    nbytes = 2 * (2 * B * T * H * D) + kv_bytes
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def dense_library(case, q, kv, qo, kl, iters):
    """The library route for the same function: SDPA with the same mask
    over bf16 K/V; int8 K/V are dequantized to bf16 first, and that pass is
    timed too. Returns (dequantize ms or None, SDPA ms), or (None, None)
    where softcap or sinks leave no single call."""
    if case["softcap"] or case["sinks"]:
        return None, None
    B, T, S, W = case["B"], case["T"], case["S"], case["window"]
    if case["slot"] is not None:
        kv = [t[case["slot"]:case["slot"] + 1] for t in kv]
    deq_ms = None
    if len(kv) == 4:
        def dequantize():
            return tuple((sym.float() * sc[:, None, :, None]).bfloat16()
                         for sym, sc in ((kv[0], kv[2]), (kv[1], kv[3])))
        deq_ms = cuda_ms(dequantize, iters=min(iters, 20))
        k, v = dequantize()
    else:
        k, v = kv
    qh = q.transpose(1, 2).contiguous()
    if not W and T == S and case["q_off"] == [0] * B:
        mask_kw = {"is_causal": True}
    else:
        kpos = torch.arange(S, device="cuda")[None, None]
        qpos = (qo[:, None] + torch.arange(T, device="cuda")[None])[:, :,
                                                                    None]
        mask = (kpos <= qpos) & (kpos < kl[:, None, None])
        if W and case["kind"] == "chunked":
            mask &= (kpos // W) == (qpos // W)
        elif W:
            mask &= kpos > qpos - W
        mask_kw = {"attn_mask": mask[:, None]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return deq_ms, cuda_ms(
        lambda: sdpa(qh, k, v, enable_gqa=True, scale=case["sm_scale"],
                     **mask_kw), iters=iters)


# ------------------------------------------- the paged kernels' shapes ---

# serving geometry of path A: prompts of 2049 tokens, up to 96 new tokens
PAGED_MAX_SEQ = 2176
# page-table widths the engines give the kernels: S + 1 parking position
NP_TINYLLAMA = -(-(PAGED_MAX_SEQ + 1) // PAGE)
NP_PHI3 = -(-(4096 + 1) // PAGE)
PHI3_WINDOW = 2047


def paged_cases():
    """The shapes the two paged paths give the four kernels, each for the
    bf16 and the int8 arena. ``table``: "fragmented" (a seeded permutation
    of page ids), "consecutive", and rows listed in ``idle`` all point at
    the null page 0, as the engine's idle decode rows do (parked at
    position S, kv_len S + 1)."""
    tiny = dict(H=32, Hkv=4, D=64, window=None)
    phi3 = dict(H=32, Hkv=32, D=96, window=PHI3_WINDOW)
    S = PAGED_MAX_SEQ
    shapes = [
        # path A, tinyllama (D 64): the streaming kernels
        dict(name="tinyllama serving decode, 4 rows live", B=4, T=1,
             q_off=[2100, 2080, 2120, 2060], NP=NP_TINYLLAMA, **tiny),
        dict(name="tinyllama serving decode, 1 of 4 rows live", B=4, T=1,
             q_off=[2100, S, S, S], NP=NP_TINYLLAMA, idle=[1, 2, 3], **tiny),
        dict(name="tinyllama serving decode, the live row alone", B=1, T=1,
             q_off=[2100], NP=NP_TINYLLAMA, **tiny),
        dict(name="tinyllama serving prefill segment", B=1, T=512,
             q_off=[1536], NP=NP_TINYLLAMA, **tiny),
        dict(name="tinyllama decode 16k, fragmented pages", B=4, T=1,
             q_off=[16383, 9000, 3000, 0], NP=257, **tiny),
        dict(name="tinyllama decode 16k, consecutive pages", B=4, T=1,
             q_off=[16383, 9000, 3000, 0], NP=257, table="consecutive",
             **tiny),
        # path B, Phi-3-mini-4k (D 96, window 2047): one page per step
        dict(name="phi3 serving decode", B=2, T=1, q_off=[3010, 2990],
             NP=NP_PHI3, **phi3),
        dict(name="phi3 serving prefill segment", B=1, T=512, q_off=[2560],
             NP=NP_PHI3, **phi3),
    ]
    cases = []
    for quant in (False, True):
        for shape in shapes:
            stream = shape["D"] == 64
            kernel = (("quantized_" if quant else "") + "paged_attention"
                      + ("_dma" if stream else ""))
            cases.append(dict(shape, kernel=kernel, quant=quant,
                              kv_len=[o + shape["T"] for o in shape["q_off"]],
                              table=shape.get("table", "fragmented"),
                              idle=shape.get("idle", [])))
    return cases


def make_paged_inputs(case, gen):
    """A layer's slice of an arena, as ``forward_paged*`` passes it, and a
    page table of distinct ids per live sequence. Returns (args, kwargs) of
    the case's entry point and of its plain version."""
    dev = "cuda"
    B, T, H, Hkv, D, NP = (case[k] for k in ("B", "T", "H", "Hkv", "D", "NP"))
    P = B * NP + 1
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    if case["table"] == "fragmented":
        ids = torch.randperm(P - 1, generator=gen, device=dev) + 1
    else:
        ids = torch.arange(1, P, device=dev)
    table = ids.reshape(B, NP).to(torch.int32)
    for b in case["idle"]:
        table[b] = 0
    table = table.contiguous()
    qo = torch.tensor(case["q_off"], dtype=torch.int32, device=dev)
    kl = torch.tensor(case["kv_len"], dtype=torch.int32, device=dev)
    kw = dict(sliding_window=case["window"])
    if case["quant"]:
        arena = torch.randint(-127, 128, (2, P, Hkv, PAGE, D), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        # scales of unit-variance tokens: absmax / 127 is about 0.03
        scale = (torch.rand((2, P, PAGE), generator=gen, device=dev) * 0.02
                 + 0.02)
        return (q, arena[0], arena[1], scale[0], scale[1], table, qo, kl), kw
    arena = torch.randn((2, P, Hkv, PAGE, D), generator=gen,
                        device=dev).bfloat16()
    return (q, arena[0], arena[1], table, qo, kl), kw


def paged_plain(case):
    return (pa.quantized_paged_attention_reference if case["quant"]
            else pa.paged_attention_reference)


def paged_live(case):
    """Per sequence: (live (query, key) pairs, live pages). A key is live
    for a query under the causal limit, kv_len and the window; a page is
    live when it holds a key that some query of the sequence sees."""
    pairs, pages = 0, 0
    W = case["window"]
    for b, (q_off, kv_len) in enumerate(zip(case["q_off"], case["kv_len"])):
        qpos = q_off + np.arange(case["T"])
        hi = np.minimum(qpos, kv_len - 1)  # last live key of each query
        lo = np.maximum(qpos - W + 1, 0) if W else np.zeros_like(qpos)
        pairs += int(np.maximum(hi - lo + 1, 0).sum())
        if b in case["idle"]:
            continue  # every slot of an idle row is the one null page
        if hi.max() >= lo.min():
            pages += int(hi.max()) // PAGE - int(lo.min()) // PAGE + 1
    return pairs, pages + bool(case["idle"])


def paged_bound(case):
    """Least time (ms) for the work these inputs need: 4*D operations per
    live (query, key) pair and query head; bytes are q and out once, the
    live K/V pages once and, for an int8 arena, their scale rows."""
    pairs, pages = paged_live(case)
    B, T, H, Hkv, D = (case[k] for k in ("B", "T", "H", "Hkv", "D"))
    flops = 4.0 * D * H * pairs
    kv_bytes = 2 * pages * Hkv * PAGE * D * (1 if case["quant"] else 2)
    if case["quant"]:
        kv_bytes += 2 * pages * PAGE * 4
    nbytes = 2 * (2 * B * T * H * D) + kv_bytes
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


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


def _top1_margin(got, want):
    """How far below its best logit ``want`` puts the token that ``got``
    puts first, in units of the rms of ``want``: 0 when the top-1 agree."""
    return ((want.max() - want[got.argmax()])
            / want.square().mean().sqrt()).item()


def _logits_agree(name, got, want, tol=REL_L2_REUSE, same_top1=True,
                  near_tie=False):
    """Relative L2 within ``tol`` and (unless ``same_top1`` is off) the
    same top-1, per request. With ``near_tie`` the top-1 may instead be a
    token that ``want`` itself puts within ``TOP1_MARGIN`` of its best."""
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    same_top = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    margin = [_top1_margin(g, w) for g, w in zip(got, want)]
    top_ok = (not same_top1 or all(same_top)
              or (near_tie and max(margin) <= TOP1_MARGIN))
    ok = top_ok and max(rel) <= tol
    note = "" if same_top1 else " (reported)"
    if near_tie:
        note = (f" margin {[f'{m:.3e}' for m in margin]} of the reference's "
                f"rms (at most {TOP1_MARGIN})")
    log(f"  {name}: logits rel_l2 {[f'{r:.3e}' for r in rel]} same top-1 "
        f"{same_top}{note} (tolerance {tol}) {'ok' if ok else 'FAILED'}")
    return ok


def phase_serving(cfg, params, kv_dtype="native"):
    """Greedy requests, 32 new tokens each, served in 512-token prefill
    segments by an engine with a "cuda" cache tier, over the native pool or
    (``kv_dtype="int8"``, path C) the int8 pool.

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

    Over the int8 pool a stored slot is dequantized to bf16 and a cache hit
    is quantized again. K and V are bf16, so a token's scale and symbols
    survive that round trip unchanged (``phase_int8_bench`` holds it to
    that), and the int8 pool is held to the same comparisons as the native
    one. Returns (the repeated prompts, wave 1's first-token logits).
    """
    log(f"== phase {'4' if kv_dtype == 'native' else '6c'}: ServingEngine, "
        f"four waves, {kv_dtype} pool")
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
                            prefill_token_budget=3 * 512, kv_dtype=kv_dtype)
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
    w1, l1 = wave(eng, "wave 1", repeat)
    w2, l2 = wave(eng, "wave 2", repeat)
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
    return repeat, l1


# ---------------------------------------------------------- phases 5, 6 ---

TIGHT_PAGES = 101  # wave 4's arena: 100 usable pages for 3 x 34


def _tier(name, cfg):
    return LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name=name, world_size=1, worker_id=0,
                              fmt="vllm", dtype=cfg.dtype))


def paged_engine(cfg, params, **kw):
    """A PagedServingEngine (page 64, 512-token prefill segments) that keeps
    what the checks read: ``prefill_logits[request_id]``, one ``(tokens
    sampled before, logits)`` per completed prefill (the first token; then
    one per resume after a preemption), ``injected_pages``, the pages
    written by ``_inject_pages``, and ``decode_logits``, the logits of every
    batched decode step once ``keep_decode_logits`` is set."""
    eng = PagedServingEngine(cfg, params, page_size=PAGE, prefill_chunk=512,
                             **kw)
    eng.prefill_logits = {}
    eng.injected_pages = 0
    eng.keep_decode_logits = False
    eng.decode_logits = []
    finish, inject, forward = (eng._finish_prefill, eng._inject_pages,
                               eng._forward)

    def finish_and_keep(req, logits):
        eng.prefill_logits.setdefault(req.request_id, []).append(
            (len(req.output_tokens), logits.float().clone()))
        finish(req, logits)

    def inject_and_count(blob, pages):
        eng.injected_pages += len(pages)
        inject(blob, pages)

    def forward_and_keep(params, cfg, tokens, *args, **kwargs):
        logits, pool = forward(params, cfg, tokens, *args, **kwargs)
        if eng.keep_decode_logits and tokens.shape == (eng.B, 1):
            eng.decode_logits.append(logits[:, 0].float().clone())
        return logits, pool

    eng._finish_prefill = finish_and_keep
    eng._inject_pages = inject_and_count
    eng._forward = forward_and_keep
    return eng


def paged_wave(eng, name, prompts, max_new):
    """Serve ``prompts`` greedily. Returns (requests, first-token logits,
    pages injected from the cache tier)."""
    injected = eng.injected_pages
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, SamplingParams(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.cache_engine is not None:
        eng.cache_engine.engine_.flush()
    injected = eng.injected_pages - injected
    first = min(r.arrival_s + r.ttft_s for r in reqs)
    last = max(r.finish_s for r in reqs)
    n_dec = sum(len(r.output_tokens) - 1 for r in reqs)
    log(f"  {name}: TTFT ms {[round(r.ttft_s * 1e3, 2) for r in reqs]} "
        f"cached_prefix_len {[r.cached_prefix_len for r in reqs]} injected "
        f"pages {injected} preemptions {[r.num_preemptions for r in reqs]} "
        f"decode {n_dec / (last - first):.1f} tok/s, wall {wall:.2f} s")
    for r in reqs:
        if len(r.output_tokens) != max_new:
            raise SystemExit(f"{name}: request {r.request_id} ended with "
                             f"{len(r.output_tokens)} of {max_new} tokens")
    first_logits = [eng.prefill_logits[r.request_id][0][1] for r in reqs]
    return reqs, first_logits, injected


def profile_decode_step(eng, prompts, arena):
    """Bring the prompts to decode, then time and profile one batched
    decode step (3 of the 4 rows live, the fourth parked on the null
    page)."""
    for p in prompts:
        eng.add_request(Request(p, SamplingParams(max_new_tokens=16)))
    while eng.waiting or eng.prefilling:
        eng.step()
    step_ms = wall_best(eng.step)
    prof = profile_window(f"paged decode step, {arena} arena, 3 of 4 rows "
                          f"live (step alone {step_ms:.3f} ms, best of 3)",
                          eng.step)
    eng.run()
    prof["step_ms"] = step_ms
    return prof


def paged_tinyllama_waves(cfg, params, prompts, dense_logits, kv_dtype):
    """The four waves over one arena dtype. Returns (wave 1's first-token
    logits, the decode step's profile)."""
    native = kv_dtype == "native"
    arena = "bf16" if native else "int8"
    log(f"  -- {arena} arena")
    tier = _tier(f"tinyllama-1.1b-paged-{arena}", cfg)
    kw = dict(max_batch=4, max_seq=PAGED_MAX_SEQ, cache_engine=tier,
              prefill_token_budget=3 * 512, kv_dtype=kv_dtype)
    n = len(prompts)
    hit = (len(prompts[0]) - 1) // PAGE * PAGE  # whole pages, last token out
    # an int8 arena re-quantizes what comes back from the tier
    tol = REL_L2_REUSE if native else REL_L2_INT8
    failed = []

    eng = paged_engine(cfg, params, num_pages=256, **kw)
    w1, l1, _ = paged_wave(eng, "wave 1 (fresh prompts)", prompts, 32)
    if native and not _logits_agree("wave 1 vs the dense engine's wave 1",
                                    l1, dense_logits):
        failed.append("wave 1 disagrees with the dense engine")
    w2, _, inj2 = paged_wave(eng, "wave 2 (resident pages)", prompts, 32)
    d12 = _first_diverging(w1, w2)
    log(f"  wave 2: first differing token vs wave 1 {d12}")
    if not (all(r.cached_prefix_len == hit for r in w2) and inj2 == 0
            and d12 == [None] * n):
        failed.append("wave 2 was not served from resident pages alone, or "
                      "changed greedy tokens")
    profile = profile_decode_step(eng, prompts, arena)

    # a fresh engine on the same tier: nothing resident
    eng = paged_engine(cfg, params, num_pages=256, **kw)
    w3, l3, inj3 = paged_wave(eng, "wave 3 (retrieve + inject)", prompts, 32)
    d13 = _first_diverging(w1, w3)
    log(f"  wave 3: first differing token vs wave 1 {d13}"
        f"{'' if native else ' (reported: the arena re-quantizes)'}")
    if not (all(r.cached_prefix_len == hit for r in w3)
            and inj3 == n * hit // PAGE
            and (d13 == [None] * n or not native)
            and _logits_agree("wave 3 vs wave 1", l3, l1, tol, native)):
        failed.append("wave 3 missed the tier or disagrees with wave 1")

    # wave 4: the same prompts with 96 new tokens, so that decode crosses a
    # page boundary; first on a roomy arena, then on one that cannot hold
    # three requests of 34 pages. Both engines are fresh, so both restore
    # the prompts from the tier.
    eng = paged_engine(cfg, params, num_pages=256, **kw)
    eng.keep_decode_logits = True
    ref, l_ref, _ = paged_wave(eng, "wave 4 reference (roomy arena)", prompts,
                               96)
    tight = paged_engine(cfg, params, num_pages=TIGHT_PAGES, **kw)
    w4, l4, _ = paged_wave(tight, f"wave 4 (arena of {TIGHT_PAGES - 1} "
                           f"pages)", prompts, 96)
    tier.close()
    d4 = _first_diverging(w4, ref)
    log(f"  wave 4: first differing token vs the roomy arena {d4} "
        f"(reported)")
    if sum(r.num_preemptions for r in w4) == 0:
        failed.append("wave 4 preempted nothing")
    if not _logits_agree("wave 4 vs the roomy arena, first token", l4, l_ref,
                         tol, native):
        failed.append("wave 4's first-token logits disagree")
    if len(eng.decode_logits) != 95:
        failed.append(f"the roomy arena decoded in {len(eng.decode_logits)} "
                      f"steps, not 95")
    for r, r_ref in zip(w4, ref):
        # each resume prefilled over the restored KV and sampled token k:
        # hold its logits against the decode step that sampled token k on
        # the roomy arena
        for k, logits in tight.prefill_logits[r.request_id][1:]:
            same_past = r.output_tokens[:k] == r_ref.output_tokens[:k]
            log(f"  wave 4: request {r.request_id} resumed at token {k} "
                f"with {r.cached_prefix_len} cached tokens; tokens before "
                f"the resume equal the roomy arena's: {same_past}")
            if not (same_past and r.cached_prefix_len >= hit
                    and _logits_agree(
                        f"wave 4 resume at token {k} vs the roomy arena",
                        [logits], [eng.decode_logits[k - 1][r_ref.slot]],
                        tol, native)):
                failed.append(f"request {r.request_id} did not resume "
                              f"where it was preempted")
    if failed:
        raise SystemExit(f"{arena} arena: " + "; ".join(failed))
    return l1, profile


def phase_paged_tinyllama(cfg, params, prompts, dense_logits):
    log("== phase 5: PagedServingEngine, tinyllama-1.1B (D 64), four waves "
        "per arena dtype")
    launches, profiles, first = {}, [], {}
    for kv_dtype, arena in (("native", "bf16"), ("int8", "int8")):
        reset_launch_counts()
        first[arena], profile = paged_tinyllama_waves(
            cfg, params, prompts, dense_logits, kv_dtype)
        launches[f"paged tinyllama {arena}"] = read_launch_counts()
        profiles.append(profile)
        torch.cuda.empty_cache()
    if not _logits_agree("int8 arena vs bf16 arena, wave 1", first["int8"],
                         first["bf16"], REL_L2_INT8, same_top1=False):
        raise SystemExit("the int8 arena's logits left the bf16 arena's")
    return launches, profiles


def phase_paged_phi3():
    log("== phase 6: PagedServingEngine, Phi-3-mini-4k (D 96, window 2047), "
        "full width and depth")
    cfg = llama.LlamaConfig.phi3_mini_4k()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3000, 2987)]
    launches, first = {}, {}
    for kv_dtype, arena in (("native", "bf16"), ("int8", "int8")):
        log(f"  -- {arena} arena")
        reset_launch_counts()
        eng = paged_engine(cfg, params, max_batch=2, max_seq=cfg.max_seq_len,
                           num_pages=128, prefill_token_budget=2 * 512,
                           kv_dtype=kv_dtype)
        plain = {}
        segment = eng._prefill_segment

        def segment_and_plain(req, pos, seg):
            """The engine's segment; for a prompt's last one, the same
            segment again with the plain attention, on a copy of the arena
            as the kernel path left it."""
            logits = segment(req, pos, seg)
            if pos + len(seg) == len(req.all_tokens):
                pool = eng.kv_pool
                pool = ({k: v.clone() for k, v in pool.items()}
                        if isinstance(pool, dict) else pool.clone())
                out, _ = eng._forward(
                    eng.params, cfg,
                    torch.as_tensor(seg, dtype=torch.long,
                                    device="cuda")[None],
                    torch.tensor([pos], dtype=torch.int32, device="cuda"),
                    pool, eng._tables(eng.page_tables[req.slot:req.slot + 1]),
                    use_kernel=False, last_logit_only=True)
                plain[req.request_id] = out[0, -1].float()
            return logits

        eng._prefill_segment = segment_and_plain
        reqs, first[arena], _ = paged_wave(eng, "two prompts, 16 new tokens",
                                           prompts, 16)
        launches[f"paged phi3 {arena}"] = read_launch_counts()
        finite = all(bool(torch.isfinite(l).all()) for l in first[arena])
        if not (finite and _logits_agree(
                "last prompt token vs forward_paged with the plain attention",
                first[arena], [plain[r.request_id] for r in reqs])):
            raise SystemExit(f"phi3 {arena} arena: the kernel path disagrees "
                             f"with the plain attention")
        del eng, plain
        torch.cuda.empty_cache()
    if not _logits_agree("int8 arena vs bf16 arena", first["int8"],
                         first["bf16"], REL_L2_INT8, same_top1=False):
        raise SystemExit("phi3: the int8 arena's logits left the bf16 "
                         "arena's")
    return launches


# ------------------------------------------------------- phases 6c-6e ---

def phase_int8_bench(cfg, params):
    """Phase 3's shape over the int8 pool: full prefill through
    ``forward_quantized``, store of the CTX prefix dequantized to bf16,
    retrieve, quantizing inject, suffix prefill."""
    log("== phase 6c: tinyllama-1.1B over the int8 pool, prefill -> store "
        "-> retrieve -> inject -> suffix prefill")
    S = CTX + SUFFIX
    rng = np.random.default_rng(0)
    tokens_np = rng.integers(0, cfg.vocab_size, S, dtype=np.int32)
    tokens = torch.as_tensor(tokens_np, device="cuda").long()[None]
    engine = _tier("tinyllama-1.1b-int8", cfg)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefill_full():
        logits, cache = llama.forward_quantized(
            params, cfg, tokens, zero,
            llama.new_quantized_kv_cache(cfg, 1, S), last_logit_only=True)
        return logits[0, -1], cache

    def prefill_reuse():
        blob, mask = engine.retrieve(tokens_np, return_tuple=False)
        if int(mask.sum()) != CTX:
            raise SystemExit(f"expected {CTX} hits, got {int(mask.sum())}")
        cache = llama.blob_into_quantized_cache(
            llama.new_quantized_kv_cache(cfg, 1, S), blob)
        logits, _ = llama.forward_quantized(
            params, cfg, tokens[:, CTX:],
            torch.full((1,), CTX, dtype=torch.int32, device="cuda"), cache,
            last_logit_only=True)
        return logits[0, -1], cache

    full_logits, full_cache = prefill_full()
    engine.store(tokens_np[:CTX], llama.quantized_cache_to_blob(
        full_cache, 0, CTX, llama.torch_dtype(cfg)))
    before = dict(qa.quantized_flash_attention.launches)
    reuse_logits, reuse_cache = prefill_reuse()
    per_forward = {k: n - before.get(k, 0) for k, n in
                   qa.quantized_flash_attention.launches.items()
                   if n != before.get(k, 0)}
    torch.cuda.synchronize()
    # what the round trip through bf16 does to the pool
    a = full_cache["sym"][..., :CTX, :].to(torch.int16)
    b = reuse_cache["sym"][..., :CTX, :].to(torch.int16)
    moved = (a != b).float().mean().item()
    step = (a - b).abs().max().item()
    scale_rel = ((full_cache["scale"][..., :CTX]
                  - reuse_cache["scale"][..., :CTX]).abs()
                 / full_cache["scale"][..., :CTX]).max().item()
    del a, b, full_cache, reuse_cache
    rel = ((reuse_logits - full_logits).norm() / full_logits.norm()).item()
    tops = int(full_logits.argmax()), int(reuse_logits.argmax())
    finite = bool(torch.isfinite(full_logits).all()
                  and torch.isfinite(reuse_logits).all())
    log(f"  store-back to bf16 and quantizing inject: {moved:.4%} of the "
        f"prefix's symbols moved, by at most {step}; scales moved by at "
        f"most {scale_rel:.3e} of their value")
    log(f"  logits finite {finite}; top-1 full {tops[0]} reuse {tops[1]}; "
        f"rel_l2 {rel:.3e} (tolerance {REL_L2_REUSE}); launches of one "
        f"reuse forward {per_forward}")
    if moved or step or scale_rel:
        raise SystemExit("int8 pool: the store-back to bf16 and the "
                         "quantizing inject changed the pool")
    if not (finite and tops[0] == tops[1] and rel <= REL_L2_REUSE):
        raise SystemExit("int8 pool: reuse logits disagree with the full "
                         "prefill")
    if per_forward != {"prefill": cfg.n_layers}:
        raise SystemExit("int8 pool: not one kernel launch a layer")
    t_full = wall_best(lambda: prefill_full())
    t_reuse = wall_best(lambda: prefill_reuse())
    log(f"  TTFT full {t_full:.2f} ms, TTFT reuse {t_reuse:.2f} ms, "
        f"ratio {t_full / t_reuse:.2f}x (best of 3 after a warm-up)")
    profile = [profile_window("int8 full prefill", lambda: prefill_full()),
               profile_window("int8 reuse request", lambda: prefill_reuse())]
    engine.close()
    return {"ttft_full_ms": t_full, "ttft_reuse_ms": t_reuse,
            "speedup": t_full / t_reuse, "symbols_moved": moved,
            "reuse_rel_l2": rel, "profile": profile}


def profile_dense_decode_step(cfg, params, prompts, kv_dtype):
    """Bring three prompts to decode on a four-slot dense engine, then time
    and profile one batched decode step (the fourth row parked)."""
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=2048 + 64,
                        prefill_chunk=512, prefill_token_budget=3 * 512,
                        kv_dtype=kv_dtype)
    for p in prompts:
        eng.add_request(Request(p, SamplingParams(max_new_tokens=16)))
    while eng.waiting or eng.prefilling:
        eng.step()
    step_ms = wall_best(eng.step)
    prof = profile_window(f"dense decode step, {kv_dtype} pool, 3 of 4 rows "
                          f"live (step alone {step_ms:.3f} ms, best of 3)",
                          eng.step)
    eng.run()
    prof["step_ms"] = step_ms
    return prof


def phase_int8_dense(cfg, params, prompts, native_logits):
    """Path C. Returns (launch counts by sub-phase, the bench numbers, the
    decode-step profiles of both pools)."""
    launches = {}
    reset_launch_counts()
    bench = phase_int8_bench(cfg, params)
    launches["int8 dense bench"] = read_launch_counts()
    torch.cuda.empty_cache()
    reset_launch_counts()
    _, l1 = phase_serving(cfg, params, kv_dtype="int8")
    launches["int8 dense serving"] = read_launch_counts()
    if not _logits_agree("int8 pool vs native pool, wave 1", l1,
                         native_logits, REL_L2_INT8, same_top1=False):
        raise SystemExit("the int8 pool's logits left the native pool's")
    profiles = [profile_dense_decode_step(cfg, params, prompts, kv_dtype)
                for kv_dtype in ("native", "int8")]
    reset_launch_counts()
    return launches, bench, profiles


def phase_mistral():
    """Path D: Mistral-7B at full width and depth on the dense engine, the
    window cutting every prompt, native then int8 pool."""
    log("== phase 6d: ServingEngine, Mistral-7B (32 layers, 32/8 heads, "
        "D 128, window 4096), prompts past the window")
    cfg = llama.LlamaConfig.mistral_7b()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in MISTRAL_PROMPTS]
    launches, first, profiles = {}, {}, []
    for kv_dtype in ("native", "int8"):
        log(f"  -- {kv_dtype} pool")
        reset_launch_counts()
        eng = ServingEngine(cfg, params, max_batch=2, max_seq=MISTRAL_SEQ,
                            prefill_chunk=512, prefill_token_budget=2 * 512,
                            kv_dtype=kv_dtype)
        pool = eng.kv_pool
        pool_bytes = sum(t.numel() * t.element_size() for t in (
            pool.values() if isinstance(pool, dict) else [pool]))
        kept, plain = {}, {}
        segment, finish = eng._prefill_segment, eng._finish_prefill

        def segment_and_plain(req, pos, seg):
            """The engine's segment; for a prompt's last one, the same
            segment again with the plain attention, on a copy of the slot as
            the kernel path left it."""
            logits = segment(req, pos, seg)
            if pos + len(seg) == len(req.all_tokens):
                view = eng._slot_view(req.slot)
                copy = ({k: v.clone() for k, v in view.items()}
                        if isinstance(view, dict) else view.clone())
                out, _ = eng._forward(
                    eng.params, cfg,
                    torch.as_tensor(seg, dtype=torch.long,
                                    device="cuda")[None],
                    torch.tensor([pos], dtype=torch.int32, device="cuda"),
                    copy, use_kernel=False, last_logit_only=True)
                plain[req.request_id] = out[0, -1].float()
            return logits

        def finish_and_keep(req, logits):
            kept[req.request_id] = logits.float().clone()
            finish(req, logits)

        # timed pass: the engine as a user runs it
        eng._finish_prefill = finish_and_keep
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, SamplingParams(max_new_tokens=16))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"mistral {kv_dtype}"] = read_launch_counts()
        start = min(r.arrival_s + r.ttft_s for r in reqs)
        last = max(r.finish_s for r in reqs)
        n_dec = sum(len(r.output_tokens) - 1 for r in reqs)
        log(f"  pool {pool_bytes / 1e9:.3f} GB; TTFT ms "
            f"{[round(r.ttft_s * 1e3, 2) for r in reqs]} (the second waits "
            f"for the first's segments) decode {n_dec / (last - start):.1f} "
            f"tok/s, wall {wall:.2f} s")
        first[kv_dtype] = [kept[r.request_id] for r in reqs]
        ok = all(len(r.output_tokens) == 16 for r in reqs) and all(
            bool(torch.isfinite(l).all()) for l in first[kv_dtype])
        # checked pass: the same prompts, each last segment also through the
        # plain attention
        eng._prefill_segment = segment_and_plain
        reqs = eng.generate(prompts, SamplingParams(max_new_tokens=2))
        if not (ok and _logits_agree(
                "last prompt token vs the same forward with the plain "
                "attention", [kept[r.request_id] for r in reqs],
                [plain[r.request_id] for r in reqs], near_tie=True)):
            raise SystemExit(f"mistral {kv_dtype} pool: the kernel path "
                             f"disagrees with the plain attention")
        # one prefill segment at positions 5120..5631, past the window
        eng._prefill_segment = segment
        req = eng.add_request(Request(prompts[0],
                                      SamplingParams(max_new_tokens=2)))
        while (req.prefill_pos or 0) < 5120:
            eng.step()
        profiles.append(profile_window(
            f"mistral prefill segment at 5120, {kv_dtype} pool", eng.step))
        eng.run()
        del eng, pool, plain, kept
        torch.cuda.empty_cache()
    if not _logits_agree("int8 pool vs native pool", first["int8"],
                         first["native"], REL_L2_INT8, same_top1=False):
        raise SystemExit("mistral: the int8 pool's logits left the native "
                         "pool's")
    reset_launch_counts()
    return launches, profiles


def phase_streamed_prefill(cfg, params):
    """Row 2 has no caller on a serving path (as in the JAX package), so
    this script gives it one: phase 3's full prefill with the model's
    attention bound to ``flash_attention_dma`` for the length of one
    forward, its logits held to the same forward through
    ``flash_attention``."""
    log("== phase 6e: tinyllama-1.1B full prefill through "
        "flash_attention_dma")
    S = CTX + SUFFIX
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, S,
                                          dtype=np.int32),
        device="cuda").long()[None]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefill():
        logits, _ = llama.forward(params, cfg, tokens, zero,
                                  llama.new_kv_cache(cfg, 1, S),
                                  last_logit_only=True)
        return logits[0, -1]

    def streamed(q, k, v, q_offset, kv_len, *, kv_head_major, sm_scale,
                 sliding_window, window_kind, logit_softcap, sinks):
        if not kv_head_major or sliding_window or logit_softcap or (
                sinks is not None):
            raise SystemExit("flash_attention_dma does not take this call")
        return ops.flash_attention_dma(q, k, v, q_offset, kv_len,
                                       sm_scale=sm_scale)

    want = prefill()
    reset_launch_counts()
    through_row_1 = llama.flash_attention
    llama.flash_attention = streamed
    try:
        got = prefill()
        t_stream = wall_best(prefill)
    finally:
        llama.flash_attention = through_row_1
    launches = read_launch_counts()
    t_flash = wall_best(prefill)
    reset_launch_counts()
    log(f"  TTFT full through flash_attention_dma {t_stream:.2f} ms, "
        f"through flash_attention {t_flash:.2f} ms (best of 3)")
    if not _logits_agree("streamed vs flash_attention", [got], [want]):
        raise SystemExit("flash_attention_dma's prefill disagrees")
    return {"streamed prefill": launches}, {
        "ttft_stream_ms": t_stream, "ttft_flash_ms": t_flash}


# ---------------------------------------------------------------- phase 8 ---

def cuda_ms_cold(fn, iters):
    """Mean device time of ``fn`` in ms with the L2 cache flushed before
    every call (a 128 MiB buffer is overwritten; the flush is outside the
    timed events): what a caller pays who finds the arena cold, as a decode
    step does that reads another layer's pages in each launch."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    fn()
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def phase_yardstick():
    """{kernel: rows}, one row per shape."""
    log("== phase 8: kernel time vs bound, plain version and library calls")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {name: [] for name in KERNELS}
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
        log(f"  flash_attention | {name}: kernel {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, SDPA "
            f"{library_ms:.4f} ms")
        rows["flash_attention"].append(row)
        del q, k, v, qh, mask_kw

    for case in dense_cases():
        q, kv, qo, kl, kw = make_dense_inputs(case, gen)
        iters = 200 if case["T"] == 1 else 20
        ms = cuda_ms(lambda: dense_call(case, q, kv, qo, kl, kw),
                     iters=iters)
        plain_ms = cuda_ms(lambda: dense_plain(case, q, kv, qo, kl, kw),
                           iters=3, warmup=1)
        deq_ms, sdpa_ms = dense_library(case, q, kv, qo, kl, iters)
        bound_ms, bound_by = dense_bound(case)
        row = {"shape": case["name"], "ms": ms, "plain_ms": plain_ms,
               "library_ms": (None if sdpa_ms is None
                              else (deq_ms or 0.0) + sdpa_ms),
               "library_dequantize_ms": deq_ms, "library_sdpa_ms": sdpa_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if case["kernel"] == "flash_attention_dma":
            # beside row 1 on the same inputs, in turns
            row["flash_attention_ms"] = cuda_ms(
                lambda: ops.flash_attention(q, *kv, qo, kl,
                                            kv_head_major=True, **kw),
                iters=iters)
            row["ms_again"] = cuda_ms(
                lambda: dense_call(case, q, kv, qo, kl, kw), iters=iters)
        lib = ("none" if sdpa_ms is None else
               (f"dequantize {deq_ms:.4f} ms + " if deq_ms is not None
                else "") + f"SDPA {sdpa_ms:.4f} ms")
        extra = (f", flash_attention {row['flash_attention_ms']:.4f} ms, "
                 f"again {row['ms_again']:.4f} ms"
                 if "ms_again" in row else "")
        log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms"
            f"{extra}, bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms, library {lib}")
        rows[case["kernel"]].append(row)
        del q, kv

    for case in paged_cases():
        args, kw = make_paged_inputs(case, gen)
        entry = KERNELS[case["kernel"]][0]
        plain = paged_plain(case)
        iters = 200 if case["T"] == 1 else 20
        ms = cuda_ms(lambda: entry(*args, **kw), iters=iters)
        cold_ms = cuda_ms_cold(lambda: entry(*args, **kw), iters=50)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        gather_ms, sdpa_ms = paged_library(case, args, iters)
        bound_ms, bound_by = paged_bound(case)
        row = {"shape": case["name"], "ms": ms, "cold_ms": cold_ms,
               "plain_ms": plain_ms, "library_ms": gather_ms + sdpa_ms,
               "library_gather_ms": gather_ms, "library_sdpa_ms": sdpa_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms (L2 "
            f"flushed before each launch: {cold_ms:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"gather {gather_ms:.4f} ms + SDPA {sdpa_ms:.4f} ms")
        rows[case["kernel"]].append(row)
        del args
    return rows


def paged_library(case, args, iters):
    """No single PyTorch call reads a paged arena: the library yardstick is
    the gather of the live pages into dense bf16 K/V [B, H_kv, S, D]
    (dequantized for an int8 arena), then SDPA over it with the same mask.
    Returns (gather ms, SDPA ms)."""
    if case["quant"]:
        q, k_pool, v_pool, k_scale, v_scale, table, qo, kl = args
    else:
        q, k_pool, v_pool, table, qo, kl = args
        k_scale = v_scale = None
    B, T, Hkv, D = case["B"], case["T"], case["Hkv"], case["D"]
    n_live = -(-max(case["kv_len"]) // PAGE)
    ids = table[:, :n_live].long()
    S = n_live * PAGE

    def dense(pool, scale):
        x = pool[ids]  # [B, n, H_kv, page, D]
        if scale is not None:
            x = (x.float() * scale[ids][:, :, None, :, None]).bfloat16()
        return x.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D)

    def gather():
        return dense(k_pool, k_scale), dense(v_pool, v_scale)

    k, v = gather()
    qh = q.transpose(1, 2).contiguous()
    kpos = torch.arange(S, device="cuda")[None, None]
    qpos = (qo[:, None] + torch.arange(T, device="cuda")[None])[:, :, None]
    mask = (kpos <= qpos) & (kpos < kl[:, None, None])
    if case["window"]:
        mask &= kpos > qpos - case["window"]
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (cuda_ms(gather, iters=iters),
            cuda_ms(lambda: sdpa(qh, k, v, attn_mask=mask, enable_gqa=True),
                    iters=iters))


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

    # every path is driven with the counts at 0 and read just after
    launches = {}
    reset_launch_counts()
    ttft = phase_main_path(cfg, params)
    launches["main_path"] = read_launch_counts()
    reset_launch_counts()
    prompts, dense_logits = phase_serving(cfg, params)
    launches["serving"] = read_launch_counts()
    paged_launches, decode_profiles = phase_paged_tinyllama(
        cfg, params, prompts, dense_logits)
    launches.update(paged_launches)
    int8_launches, int8_bench, dense_decode_profiles = phase_int8_dense(
        cfg, params, prompts, dense_logits)
    launches.update(int8_launches)
    stream_launches, stream_ttft = phase_streamed_prefill(cfg, params)
    launches.update(stream_launches)
    del params, dense_logits
    torch.cuda.empty_cache()
    launches.update(phase_paged_phi3())
    mistral_launches, mistral_profiles = phase_mistral()
    launches.update(mistral_launches)
    reset_launch_counts()

    log("== phase 7: launch counts")
    for phase, counts in launches.items():
        log(f"  {phase}: {counts}")
    expected = {
        "main_path": ("flash_attention", ("prefill",)),
        "serving": ("flash_attention", ("prefill", "decode")),
        "paged tinyllama bf16": ("paged_attention_dma",
                                 ("prefill", "decode")),
        "paged tinyllama int8": ("quantized_paged_attention_dma",
                                 ("prefill", "decode")),
        "paged phi3 bf16": ("paged_attention", ("prefill", "decode")),
        "paged phi3 int8": ("quantized_paged_attention",
                            ("prefill", "decode")),
        "int8 dense bench": ("quantized_flash_attention", ("prefill",)),
        "int8 dense serving": ("quantized_flash_attention",
                               ("prefill", "decode")),
        "streamed prefill": ("flash_attention_dma", ("prefill",)),
        "mistral native": ("flash_attention",
                           ("prefill+window", "decode+window")),
        "mistral int8": ("quantized_flash_attention",
                         ("prefill+window", "decode+window")),
    }
    for phase, (kernel, kinds) in expected.items():
        for kind in kinds:
            if launches[phase].get(kernel, {}).get(kind, 0) <= 0:
                raise SystemExit(f"{kernel}: no {kind} launch in {phase}")

    rows = phase_yardstick()
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        by_phase = {phase: counts[name] for phase, counts in launches.items()
                    if name in counts}
        head = rows[name][0]  # the first shape its path gives it
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(sum(c.values()) for c in by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max_abs[name],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shapes": rows[name],
        })
    record = {"kernels": kernels, "ttft": ttft, "ttft_int8": int8_bench,
              "ttft_streamed": stream_ttft,
              "paged_decode_profiles": decode_profiles,
              "dense_decode_profiles": dense_decode_profiles,
              "mistral_profiles": mistral_profiles, "card": card}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
