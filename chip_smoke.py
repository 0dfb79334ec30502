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
   and with the same options), the four paged-attention kernels (bf16
   and int8 arenas), the two range coders (tolerance 0) and the six MLA
   latent-attention entry points (dense, paged one page per step, paged
   streamed; bf16 and int8 latents) at DeepSeek-V2-Lite's shapes and at
   128 heads, V2/V3's;
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
9. remote CacheGen reuse through the port's cache server (a subprocess):
   instance A stores phase 3's 15872-token prefix with the CacheGen serde
   (quantize, CDF, one range-encoder launch a half, row 12); every
   container must equal the host C++ coder's, the card's quantizer and CDF
   the CPU's. A fresh pipelined instance B under a ``ServingEngine`` serves
   the 16384-token prompt: groups of 16 still-coded chunks, one
   range-decoder launch a group (row 11), dequantize, inject, suffix
   prefill; every group's symbols must equal the host C++ decode, the slot
   the KV of ``retrieve()`` with the host decoder. TTFT remote (best of 3
   and median, each request a new suffix) beside phase 3's TTFT full, the
   stage split of bench.py:470-526, a ``torch.profiler`` window of one
   request, and a ``PagedServingEngine`` wave over the same server whose
   pages must equal the dense slot (``phase_remote``); 9b: codec throughput
   at bench.py's reference geometry (``phase_codec_throughput``);
10. MLA, DeepSeek-V2-Lite at full width and depth (27 layers, 16 heads,
   latent 576, 64 routed + 2 shared experts; random bf16 weights from a
   seeded generator, 31.4 GB; ``phase_mla``): 10a the bench shape through
   ``mla.forward`` (full prefill, store of the CTX prefix's latent blobs
   into the "cuda" tier, retrieve, inject, suffix prefill; reuse logits
   held to the full prefill's; TTFT full and reuse, a profiler window
   each); 10b phase 4's four waves on ``MLAServingEngine`` over the native
   and the int8 latent pool, and a profiled decode step; 10c phase 5's
   waves on ``MLAPagedServingEngine`` (page 64), bf16 then int8 arena, the
   injected pages equal to the dense pool's slots; 10d kernel row 9, which
   no serving path calls: the last prefill segment again with the paged
   forward's attention bound to it, logits held to row 10's; 10e the latent
   prefix through the cache server with CacheGen (N = 1 containers equal to
   the host C++ coder's, a fresh pipelined engine's decoded symbols equal
   to the host decode; logits and wire bytes reported). Where phase 10
   compares tokens computed in other shapes, phase 6d's near-tie top-1
   rule applies and the logits are held within ``REL_L2_REUSE``, or within
   ``REL_L2_MOE`` for a request in which the two computations picked other
   experts for some (layer, token), which then also holds ``REL_L2_REUSE``
   when run again with the reference's routing forced;
11. kernel row 13, the prefill ablation variants, through the port's
   ablation tool (``lmcache_tpu_torch.tools.bench_prefill_mfu``) at the JAX
   tool's geometry, Llama-3-8B's attention (H_kv 8, G 4, D 128, S 8192,
   logical blocks 256 x 1024): the six variants (``full``, ``mxu_only``,
   ``no_mask``, ``pair``, ``pair_no_mask``, ``pipelined``) run once as the
   path, each held against its plain version and, where it computes row 1's
   function, against row 1; each timed beside its bound, its plain version,
   row 1 and SDPA (``phase_ablation``; run right after phase 2);
12. CacheBlend on a RAG-shaped prompt (8 documents of 1024 tokens and a
   128-token question, T 8320; ``phase_blend``): 12a tinyllama-1.1B after
   phase 9, 12b DeepSeek-V2-Lite at the end of phase 10 on its weights. The
   chunks are stored through the blender (rows 1 / 8); a blend at ratio 1.0
   must hold the full prefill's logits (V2-Lite: phase 10's routing rule),
   ratio 0.15 must lie closer to them than ratio 0, a second blend must miss
   nothing, and one ``context_chunks`` request through each engine (dense
   native and int8, paged; MLA dense and paged) must start with the
   blender's token; TTFT of the blend request against a full prefill of the
   same T and a profiler window of one blend admission;
7. the launch counts of phases 3 to 12, read per phase with every count
   set to 0 just before it (prefill and decode, each > 0 where the phase
   runs them; "+window" marks launches under a window; the coders count
   "store" and "retrieve" launches);
8. the yardstick: each kernel's time at phase 2's shapes beside its bound,
   its plain version and a PyTorch library time (SDPA; for a paged arena
   the gather of the live pages into dense K/V, then SDPA; for int8 K/V the
   dequantization to bf16, then SDPA; none where softcap or sinks leave no
   single call; for the latent kernels SDPA with the latents expanded over
   the heads as K and their first rank columns as V, the SDPA backends that
   take those shapes named). No PyTorch call computes a range coder: the
   coders' rows carry the host C++ coder's time at the same shape instead.

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
from lmcache_tpu_torch import blend, blend_mla, kv, ops
from lmcache_tpu_torch.chunks import prefix_chunk_hashes
from lmcache_tpu_torch.codec import CacheGenConfig, range_coder
from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops import latent_attention as la
from lmcache_tpu_torch.ops import paged_attention as pa
from lmcache_tpu_torch.ops import paged_latent_attention as pla
from lmcache_tpu_torch.ops import prefill_variants as pv
from lmcache_tpu_torch.ops import quant
from lmcache_tpu_torch.ops import quantized_attention as qa
from lmcache_tpu_torch.ops import range_decode as rd
from lmcache_tpu_torch.ops import range_encode as re_
from lmcache_tpu_torch.serving import (MLAPagedServingEngine,
                                       MLAServingEngine, PagedServingEngine,
                                       Request, SamplingParams, ServingEngine)
from lmcache_tpu_torch.storage.serde import cachegen_serde as cgs
from lmcache_tpu_torch.tools import bench_prefill_mfu as bench_mfu

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
# DeepSeek-V2-Lite's tokens computed in other shapes (a decode step against a
# prefill segment): bf16 rounding through 26 MoE layers can move a token's
# top-6 of 64 experts off a near tie, which swaps a whole expert's output
# for that token. Only a request in which such a flip was counted
# (``Routing``) is held to this, and its computation run again with the
# reference's routing forced must then hold REL_L2_REUSE
REL_L2_MOE = 1e-1

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
    "range_encode": (
        re_.encode_streams_raw, "lmcache_tpu_torch/ops/csrc/range_encode.cu",
        "lmcache_tpu/ops/range_encode.py:176"),
    "range_decode": (
        rd.decode_streams, "lmcache_tpu_torch/ops/csrc/range_decode.cu",
        "lmcache_tpu/ops/range_decode.py:222"),
    "latent_flash_attention": (
        la.latent_flash_attention,
        "lmcache_tpu_torch/ops/csrc/latent_attention.cu",
        "lmcache_tpu/ops/latent_attention.py:62"),
    "quantized_latent_flash_attention": (
        la.quantized_latent_flash_attention,
        "lmcache_tpu_torch/ops/csrc/latent_attention.cu",
        "lmcache_tpu/ops/latent_attention.py:62"),
    "paged_latent_attention": (
        pla.paged_latent_attention,
        "lmcache_tpu_torch/ops/csrc/paged_latent_attention.cu",
        "lmcache_tpu/ops/paged_latent_attention.py:54"),
    "quantized_paged_latent_attention": (
        pla.quantized_paged_latent_attention,
        "lmcache_tpu_torch/ops/csrc/paged_latent_attention.cu",
        "lmcache_tpu/ops/paged_latent_attention.py:54"),
    "paged_latent_attention_dma": (
        pla.paged_latent_attention_dma,
        "lmcache_tpu_torch/ops/csrc/paged_latent_attention.cu",
        "lmcache_tpu/ops/paged_latent_attention.py:270"),
    "quantized_paged_latent_attention_dma": (
        pla.quantized_paged_latent_attention_dma,
        "lmcache_tpu_torch/ops/csrc/paged_latent_attention.cu",
        "lmcache_tpu/ops/paged_latent_attention.py:270"),
    "variant_attention": (
        pv.variant_attention,
        "lmcache_tpu_torch/ops/csrc/prefill_variants.cu",
        "tools/bench_prefill_mfu.py:89"),
    "pipelined_attention": (
        pv.pipelined_attention,
        "lmcache_tpu_torch/ops/csrc/prefill_variants.cu",
        "tools/bench_prefill_mfu.py:153"),
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
    for case in coder_cases():
        worst[case[1]] = max(worst[case[1]], hold_coder_against_plain(case,
                                                                      gen))
    for case in latent_cases():
        args, kw = make_latent_inputs(case, gen)
        out = KERNELS[case["kernel"]][0](*args, **kw)
        ref = latent_plain(case, args, kw)
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


# ----------------------------------- rows 11 and 12: the range coders ---

REMOTE_CHUNK = 256  # chunk size of the remote path, as bench.py's
STORE_CHUNKS = CTX // REMOTE_CHUNK  # 62
GROUP_CHUNKS = ServingEngine.inject_group_chunks  # 16
TINY_CG = CacheGenConfig.from_model_name("tinyllama-1.1b", 22)
# Integer operations the coders need, counted from the kernels' source
# (ops/csrc/range_{de,en}code.cu); only the 32-bit division is taken as the
# sequence nvcc 12.8 emits for sm_90a (cuobjdump -sass): 15 integer
# instructions. Loads and stores, shared-memory reloads of the CDF and the
# division's I2F, MUFU.RCP and F2I are left out (the last three run on the
# 16-lane conversion and special-function unit of an SM: 3 a symbol there
# take an eighth of the decoder's integer time).
# Decoder, a symbol: the range shift, code - low, max(range, 1), the
# division (15), the clamp, the search (31 compares and 31 adds), cf / cfn
# (lo + 1, its test and select, low += cf * range, cfn - cf, range *=),
# the renormalization test that ends the loop (5), range == 0 and the
# loop's count and test: 95. A renormalization round (one coded byte): its
# test (4), pos < len and the select, pos++, code << 8 | byte, low <<= 8,
# range <<= 8: 11.
# Encoder, a symbol: cf and cfn (x < 32 and its select; x + 1, its test
# and select), the range shift, low += cf * range, cfn - cf, range *=, the
# test that ends the loop (4) and the loop's count and test: 15. A round:
# its test (3), pos >= stride, low >> 24, pos++, low <<= 8, range <<= 8: 8;
# each of the 4 flushed bytes of a stream: 4.
# A stream's rounds are its coded bytes less the 4 of the flush.
DEC_OPS_SYMBOL, DEC_OPS_ROUND = 95, 11
ENC_OPS_SYMBOL, ENC_OPS_ROUND, ENC_OPS_FLUSH_BYTE = 15, 8, 4
INT32_LANES = 132 * 64  # H100 SXM: 64 INT32 lanes on each of 132 SMs
PLAIN_STREAMS = 16384  # the plain coders' Python loop is timed at this S


def coder_cases():
    """(name, kernel, bins of each (chunk, half, layer) plane): the launches
    the remote path gives the coders at tinyllama (22 layers, 4 x 64 = 256
    channels, chunks of 256 tokens, one stream per channel): one half of
    the 62-chunk store (349184 streams), one retrieve group of 16 chunks
    with both halves (180224 streams)."""
    key, value = list(TINY_CG.key_bins), list(TINY_CG.value_bins)
    return [
        ("tinyllama store, one half of 62 chunks", "range_encode",
         key * STORE_CHUNKS),
        ("tinyllama retrieve group, 16 chunks x K and V", "range_decode",
         (key + value) * GROUP_CHUNKS),
    ]


def coder_inputs(case, gen):
    """Symbols of random-normal bf16 KV, quantized with the case's bins and
    laid out as the serializer's streams (uint8 [planes * 256, 256]), and
    their CDFs."""
    bins = torch.tensor(case[2], dtype=torch.int32, device="cuda")
    x = torch.randn((len(case[2]), REMOTE_CHUNK, 256), generator=gen,
                    device="cuda").bfloat16()
    sym, _ = quant.quantize(x, bins)
    streams = sym.transpose(1, 2).reshape(-1, REMOTE_CHUNK)
    return streams, quant.stream_cdf(streams)


def hold_coder_against_plain(case, gen):
    """Launch the case's kernel at its shape and hold it against its plain
    version on the same inputs: tolerance 0 (the lengths and coded bytes
    of every stream, or every symbol). Returns the max abs error (0)."""
    name, kernel, _ = case
    streams, cdf = coder_inputs(case, gen)
    out, lens = re_.encode_streams_raw(streams, cdf)
    payload = re_.compact(out, lens)
    if kernel == "range_encode":
        ref_out, ref_lens = re_.encode_streams_reference(streams, cdf)
        ref = re_.compact(ref_out, ref_lens)
        same = torch.equal(lens, ref_lens) and torch.equal(payload, ref)
        err = (lens - ref_lens).abs().max().item()
        if same:
            err = max(err, (payload.int() - ref.int()).abs().max().item())
        what = f"{int(lens.sum())} coded bytes of {streams.numel()} symbols"
    else:
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                             lens.long().cumsum(0)])
        sym = rd.decode_streams(payload, offsets, cdf, REMOTE_CHUNK)
        ref = rd.decode_streams_reference(payload, offsets, cdf,
                                          REMOTE_CHUNK)
        same = torch.equal(sym, ref) and torch.equal(sym, streams)
        err = (sym.int() - ref.int()).abs().max().item()
        what = f"{sym.numel()} symbols from {payload.numel()} coded bytes"
    torch.cuda.synchronize()
    log(f"  {kernel} | {name}: {streams.shape[0]} streams, {what}, max_abs_err "
        f"{err} (tolerance 0: equal) {'ok' if same else 'FAILED'}")
    if not same:
        raise SystemExit(f"{kernel} disagrees with its plain version at "
                         f"{name}")
    return err


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def coder_yardstick(gen, clock_hz):
    """{kernel: rows}: each coder at its path shape against its bound, its
    plain version (at PLAIN_STREAMS streams of the same data) and, as no
    PyTorch call computes a range coder, the host C++ coder at the same
    shape (host time, OpenMP threads)."""
    rows = {}
    for case in coder_cases():
        name, kernel, _ = case
        streams, cdf = coder_inputs(case, gen)
        S, T = streams.shape
        out, lens = re_.encode_streams_raw(streams, cdf)
        coded = int(lens.sum())
        sym_h, cdf_h = streams.cpu().numpy(), quant.cdf_to_numpy(cdf)
        sub = (streams[:PLAIN_STREAMS], cdf[:PLAIN_STREAMS])
        if kernel == "range_encode":
            ms = cuda_ms(lambda: re_.encode_streams_raw(streams, cdf),
                         iters=10)
            plain_ms = cuda_ms(lambda: re_.encode_streams_reference(*sub),
                               iters=1, warmup=1)
            host = wall_best(lambda: range_coder.encode_streams(sym_h, cdf_h),
                             n=1)
            ops = (ENC_OPS_SYMBOL * S * T + ENC_OPS_ROUND * (coded - 4 * S)
                   + ENC_OPS_FLUSH_BYTE * 4 * S)
            nbytes = S * T + S * 66 + coded + 4 * S
        else:
            payload = re_.compact(out, lens)
            offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                             device="cuda"),
                                 lens.long().cumsum(0)])
            ms = cuda_ms(lambda: rd.decode_streams(payload, offsets, cdf, T),
                         iters=10)
            n_sub = int(offsets[PLAIN_STREAMS])
            plain_ms = cuda_ms(lambda: rd.decode_streams_reference(
                payload[:n_sub], offsets[:PLAIN_STREAMS + 1], sub[1], T),
                iters=1, warmup=1)
            pay_h, lens_h = payload.cpu().numpy(), lens.cpu().numpy()
            host = wall_best(lambda: range_coder.decode_streams(
                pay_h, lens_h, T, cdf_h), n=1)
            ops = DEC_OPS_SYMBOL * S * T + DEC_OPS_ROUND * (coded - 4 * S)
            nbytes = coded + S * 66 + 8 * (S + 1) + S * T
        t_ops, t_bytes = ops / (INT32_LANES * clock_hz), nbytes / PEAK_BYTES_S
        bound_ms, bound_by = ((t_ops * 1e3, "operations") if t_ops >= t_bytes
                              else (t_bytes * 1e3, "bytes"))
        row = {"shape": name, "streams": S, "symbols": S * T,
               "coded_bytes": coded, "ms": ms, "plain_ms": plain_ms,
               "plain_streams": PLAIN_STREAMS, "library_ms": None,
               "host_coder_ms": host,
               "host_threads": range_coder.num_threads(),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_operations": ops, "bound_bytes": nbytes}
        log(f"  {kernel} | {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({bound_by}: {ops / 1e9:.3f} G integer operations at "
            f"{clock_hz / 1e6:.0f} MHz, {nbytes / 1e6:.1f} MB), plain "
            f"{plain_ms:.1f} ms at {PLAIN_STREAMS} streams, host C++ coder "
            f"{host:.1f} ms ({row['host_threads']} threads; no PyTorch call "
            f"computes a range coder)")
        rows[kernel] = [row]
        del streams, cdf, out, lens
    return rows


# ------------------------------- rows 8, 9 and 10: MLA latent attention ---

MLA_CFG = mla.MLAConfig.deepseek_v2_lite()  # H 16, latent 576 = 512 + 64
MLA_HEADS_V3 = mla.MLAConfig.deepseek_v3().n_heads  # 128, the same latent
MLA_SERVE_SEQ = 2048 + 64  # phases 10b and 10c: max_seq of the engines
NP_MLA = -(-(MLA_SERVE_SEQ + 1) // PAGE)
MLA_C, MLA_CP = MLA_CFG.latent_dim, mla.latent_pad_dim(MLA_CFG)
MLA_R = MLA_CFG.kv_lora_rank


def latent_cases():
    """The shapes phase 10 gives kernel rows 8-10 at DeepSeek-V2-Lite (H 16,
    C 576, rank 512), for the bf16 and the int8 latents, and decode with
    H 128, the geometry of DeepSeek-V2 and V3 (whose weights do not fit one
    card). Keys: kernel, B, T, H, q_off, kv_len; S (dense rows) or NP (page
    slots; ``idle`` rows point every slot at the null page 0, as the
    engine's parked decode rows do). The first case of a kernel is the one
    its path gives it first."""
    S16 = CTX + SUFFIX
    parked = [2064, 2060, 2070, MLA_SERVE_SEQ]
    ragged = [16383, 9000, 3000, 0]
    dense = [
        ("v2-lite suffix prefill", dict(B=1, T=SUFFIX, S=S16, q_off=[CTX])),
        ("v2-lite full prefill 16k", dict(B=1, T=S16, S=S16, q_off=[0])),
        ("v2-lite serving decode, 1 row parked",
         dict(B=4, T=1, S=MLA_SERVE_SEQ + 1, q_off=parked)),
        ("v2-lite decode 16k", dict(B=4, T=1, S=S16 + 1, q_off=ragged)),
        ("v2/v3 heads (H 128) decode 16k",
         dict(B=4, T=1, S=S16 + 1, q_off=ragged, H=MLA_HEADS_V3)),
    ]
    paged = [
        ("v2-lite serving prefill segment, page 64",
         dict(B=1, T=512, NP=NP_MLA, q_off=[1536])),
        ("v2-lite serving decode, page 64, 1 row parked",
         dict(B=4, T=1, NP=NP_MLA, q_off=parked, idle=[3])),
        ("v2-lite decode 16k, fragmented pages",
         dict(B=4, T=1, NP=257, q_off=ragged)),
        ("v2/v3 heads (H 128) decode 16k, fragmented pages",
         dict(B=4, T=1, NP=257, q_off=ragged, H=MLA_HEADS_V3)),
    ]
    cases = []
    for quant in (False, True):
        pre = "quantized_" if quant else ""
        for name, shape in dense:
            cases.append(dict(dict(H=MLA_CFG.n_heads, idle=[]), **shape,
                              name=name, quant=quant, paged=False,
                              kernel=pre + "latent_flash_attention"))
        # row 10 on every paged shape; row 9 where phase 10d gives it work
        for name, shape in paged:
            for kernel in ("paged_latent_attention_dma",
                           "paged_latent_attention"):
                if kernel == "paged_latent_attention" and "16k" in name:
                    continue
                cases.append(dict(dict(H=MLA_CFG.n_heads, idle=[]), **shape,
                                  name=name, quant=quant, paged=True,
                                  kernel=pre + kernel))
    for case in cases:
        case["kv_len"] = [o + case["T"] for o in case["q_off"]]
    return cases


def make_latent_inputs(case, gen):
    """(positional args, kwargs) of the case's entry point: dense latents
    [B, S, C] as a layer of the pool, or a lane-padded arena [P, page, Cp]
    (zero pad) with a fragmented page table; int8 latents with scales of
    unit-size tokens."""
    dev = "cuda"
    B, T, H = case["B"], case["T"], case["H"]
    q = torch.randn((B, T, H, MLA_C), generator=gen, device=dev).bfloat16()
    if case["paged"]:
        P = B * case["NP"] + 1
        shape = (P, PAGE, MLA_CP)
    else:
        shape = (B, case["S"], MLA_C)
    if case["quant"]:
        rows = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        # unit-size latents: absmax / 127 is about 0.03
        lat = (rows, torch.rand(shape[:2], generator=gen, device=dev) * 0.02
               + 0.02)
    else:
        lat = (torch.randn(shape, generator=gen, device=dev).bfloat16(),)
    if case["paged"]:
        lat[0][..., MLA_C:] = 0  # the lane pad, as the model writes it
    qo = torch.tensor(case["q_off"], dtype=torch.int32, device=dev)
    kl = torch.tensor(case["kv_len"], dtype=torch.int32, device=dev)
    kw = dict(rank=MLA_R, scale=MLA_CFG.sm_scale)
    if not case["paged"]:
        return (q, *lat, qo, kl), kw
    ids = torch.randperm(P - 1, generator=gen, device=dev) + 1
    table = ids.reshape(B, case["NP"]).to(torch.int32)
    for b in case["idle"]:
        table[b] = 0
    return (q, *lat, table.contiguous(), qo, kl), kw


def latent_plain(case, args, kw, rows=1024):
    """The case's plain version over at most ``rows`` query tokens per call,
    so that the score matrix of a 16k-token prefill fits in memory."""
    if case["paged"]:
        plain = (pla.quantized_paged_latent_attention_reference
                 if case["quant"] else pla.paged_latent_attention_reference)
    else:
        plain = (la.quantized_latent_attention_reference if case["quant"]
                 else la.latent_attention_reference)
    q, rest, (qo, kl) = args[0], args[1:-2], args[-2:]
    return torch.cat([
        plain(q[:, t:t + rows], *rest, qo + t, kl, zero_dead_rows=True, **kw)
        for t in range(0, q.shape[1], rows)], dim=1)


def latent_bound(case, args):
    """Least time (ms) for the work these inputs need: 2 * H * (C + rank)
    operations per live (query token, key) pair (scores over the C columns,
    context over the rank); bytes are q and out once and every latent row
    that a query sees once (C columns; int8: one byte each and the fp32
    scale), rows shared through the page table counted once, plus the live
    page-table entries."""
    B, T, H = case["B"], case["T"], case["H"]
    pairs = 0
    rows = set()
    table = args[-3].cpu().numpy() if case["paged"] else None
    for b, (q_off, kv_len) in enumerate(zip(case["q_off"], case["kv_len"])):
        hi = np.minimum(q_off + np.arange(T), kv_len - 1)
        pairs += int(np.maximum(hi + 1, 0).sum())
        n = int(min(q_off + T, kv_len))
        if case["paged"]:
            rows.update((int(table[b, k // PAGE]), k % PAGE)
                        for k in range(n))
        else:
            rows.update((b, k) for k in range(n))
    flops = 2.0 * H * (MLA_C + MLA_R) * pairs
    per_row = MLA_C + 4 if case["quant"] else 2 * MLA_C
    nbytes = (2 * B * T * H * (MLA_C + MLA_R) + len(rows) * per_row)
    if case["paged"]:
        nbytes += 4 * sum(-(-kl // PAGE) for kl in case["kv_len"])
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    if t_flops >= t_bytes:
        return t_flops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def sdpa_backends(call):
    """The SDPA backends that take ``call``'s shapes, in PyTorch's order."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call()
            took.append(backend.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return took


def latent_library(case, args, kw, iters):
    """The library route for the same function: SDPA with K = the latent
    rows expanded over the H heads (a view) and V = their first rank
    columns, under the same mask; the paged rows are gathered into dense
    rows first and int8 rows dequantized to bf16, and that pass is timed
    too. Returns (gather or dequantize ms or None, SDPA ms, the SDPA
    backends that take these shapes)."""
    q, qo, kl = args[0], args[-2], args[-1]
    B, T, H = case["B"], case["T"], case["H"]
    if case["paged"]:
        n_live = -(-max(case["kv_len"]) // PAGE)
        ids = args[-3][:, :n_live].long()

        def dense():
            x = args[1][ids][..., :MLA_C]  # [B, n, page, C]
            if case["quant"]:
                x = (x.float() * args[2][ids][..., None]).bfloat16()
            return x.reshape(B, n_live * PAGE, MLA_C)
    elif case["quant"]:
        def dense():
            return (args[1].float() * args[2][..., None]).bfloat16()
    else:
        def dense():
            return args[1]
    pre_ms = (cuda_ms(dense, iters=min(iters, 20))
              if case["paged"] or case["quant"] else None)
    lat = dense()
    S = lat.shape[1]
    k = lat[:, None].expand(B, H, S, MLA_C)
    v = lat[:, None, :, :MLA_R].expand(B, H, S, MLA_R)
    qh = q.transpose(1, 2).contiguous()
    if T == S and case["q_off"] == [0] * B:
        mask_kw = {"is_causal": True}
    else:
        kpos = torch.arange(S, device="cuda")[None, None]
        qpos = (qo[:, None] + torch.arange(T, device="cuda")[None])[:, :,
                                                                    None]
        mask_kw = {"attn_mask": ((kpos <= qpos)
                                 & (kpos < kl[:, None, None]))[:, None]}
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qh, k, v, scale=kw["scale"], **mask_kw)

    backends = sdpa_backends(call)
    return pre_ms, cuda_ms(call, iters=iters), backends


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
                  near_tie=False, flips=None):
    """Relative L2 within ``tol`` and (unless ``same_top1`` is off) the
    same top-1, per request. With ``near_tie`` the top-1 may instead be a
    token that ``want`` itself puts within ``TOP1_MARGIN`` of its best.
    ``flips`` gives, per request, the (MoE layer, token) top-k sets in which
    the two computations differ and those compared (:class:`Routing`): a
    request whose routing flipped is held to ``REL_L2_MOE``, every other to
    ``tol``; the distance
    between two requests' reference logits, what a wrong request would
    give, is printed beside them."""
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    same_top = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    margin = [_top1_margin(g, w) for g, w in zip(got, want)]
    top_ok = (not same_top1 or all(same_top)
              or (near_tie and max(margin) <= TOP1_MARGIN))
    tols = [max(tol, REL_L2_MOE) if flips and f[0] else tol
            for f in (flips or [(0, 0)] * len(rel))]
    ok = top_ok and all(r <= t for r, t in zip(rel, tols))
    note = "" if same_top1 else " (reported)"
    if near_tie:
        note = (f" margin {[f'{m:.3e}' for m in margin]} of the reference's "
                f"rms (at most {TOP1_MARGIN})")
    if flips is not None:
        note += f" routing flips {flips} (differing, compared)"
        if len(want) > 1:
            other = min(((a - b).norm() / b.norm()).item()
                         for i, a in enumerate(want)
                         for j, b in enumerate(want) if i != j)
            note += f" (another request's logits: rel_l2 {other:.3e})"
    log(f"  {name}: logits rel_l2 {[f'{r:.3e}' for r in rel]} same top-1 "
        f"{same_top}{note} (tolerance {tols if flips else tol}) "
        f"{'ok' if ok else 'FAILED'}")
    return ok


class Routing:
    """The routed experts that DeepSeek-V2-Lite's MoE layers pick for each
    token a watched engine computes (phase 10). While it is entered,
    ``mla._gate`` is wrapped. ``watch(eng)`` makes each forward of ``eng``
    that runs inside :func:`_recording` store, per live row, the sorted
    top-k expert ids of every MoE layer ``[n_moe, k]`` under a key of the
    token's whole prefix, so two computations of one token (a row of a
    512-token segment and a 1-token prefill, or a decode step) meet under
    one key; a later computation of a key replaces the earlier one. Tokens
    injected from a cache tier leave the record: their latents were computed
    elsewhere. At each completed prefill the request keeps a copy of the
    record as it stands (``routing_seen``, in the order of its first token
    and its resumes): the computations its logits saw. A record given as
    ``force`` replays the reference's choice for every token it holds: the
    gate's weights are taken at the forced experts, as ``mla._gate`` takes
    them."""

    def __init__(self):
        self.rows = None  # (req, position) or None per row of the forward
        self.picks = []  # the forward's top-k ids, one tensor per MoE layer
        self.force = None  # [n_moe, rows, k] forced ids, -1 where free
        self.swapped = 0  # (layer, token) sets replaced under force
        self.wave1 = {}  # the dense engine's (wave 1 record, requests)

    def __enter__(self):
        self.gate = mla._gate
        mla._gate = self._gate
        return self

    def __exit__(self, *exc):
        mla._gate = self.gate

    def _gate(self, h, lp, cfg):
        topi, topw = self.gate(h, lp, cfg)
        if self.rows is None:
            return topi, topw
        if self.force is not None:
            want = self.force[len(self.picks)]
            swap = (want[:, 0] >= 0) & (topi.sort(dim=-1).values
                                        != want).any(dim=-1)
            n = int(swap.sum())
            if n:
                logits = h.float() @ lp["router"].float()
                scores = (torch.sigmoid(logits) if cfg.arch == "v3"
                          else torch.softmax(logits, dim=-1))
                w = torch.gather(scores, -1, want.clamp(min=0))
                if cfg.norm_topk_prob:
                    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
                topi = torch.where(swap[:, None], want, topi)
                topw = torch.where(swap[:, None],
                                   w * cfg.routed_scaling_factor, topw)
                self.swapped += n
        self.picks.append(topi)
        return topi, topw

    @staticmethod
    def keys(req):
        """Keys of the tokens of ``req``'s sequence so far, each a hash
        chained over the prefix that ends at it."""
        keys = req.__dict__.setdefault("routing_keys", [])
        if len(keys) < req.total_len:
            prev = keys[-1] if keys else 0
            for t in req.all_tokens[len(keys):].tolist():
                prev = hash((prev, t))
                keys.append(prev)
        return keys

    def watch(self, eng):
        eng.routing, eng.routing_force = None, None
        segment, decode_all = eng._prefill_segment, eng._decode_all
        forward, stream_inject = eng._forward, eng._stream_inject
        finish = eng._finish_prefill
        rows_of = {}

        def finish_and_copy(req, logits):
            if eng.routing is not None:
                req.__dict__.setdefault("routing_seen", []).append(
                    dict(eng.routing))
            return finish(req, logits)

        def prefill_segment(req, pos, seg):
            rows_of["rows"] = lambda: [(req, pos + t) for t in range(len(seg))]
            try:
                return segment(req, pos, seg)
            finally:
                rows_of.clear()

        def decode():
            # the rows are read at the forward: growth may preempt first
            def rows():
                by_slot = {r.slot: r for r in eng.running}
                return [(by_slot[b], by_slot[b].total_len - 1)
                        if b in by_slot else None for b in range(eng.B)]
            rows_of["rows"] = rows
            try:
                return decode_all()
            finally:
                rows_of.clear()

        def recording_forward(*args, **kwargs):
            if eng.routing is None or "rows" not in rows_of:
                return forward(*args, **kwargs)
            rows = rows_of["rows"]()
            keys = [None if r is None else self.keys(r[0])[r[1]]
                    for r in rows]
            if eng.routing_force is not None:
                ref = eng.routing_force
                k = next(iter(ref.values())).shape
                force = np.full((k[0], len(rows), k[1]), -1, np.int64)
                for i, key in enumerate(keys):
                    if key in ref:
                        force[:, i] = ref[key]
                self.force = torch.as_tensor(force, device="cuda")
            self.rows, self.picks = rows, []
            try:
                out = forward(*args, **kwargs)
            finally:
                self.rows, self.force = None, None
            picks = torch.stack(self.picks).sort(dim=-1).values.cpu().numpy()
            for i, key in enumerate(keys):
                if key is not None:
                    eng.routing[key] = picks[:, i]
            return out

        def inject_and_forget(req, tokens):
            n = stream_inject(req, tokens)
            if eng.routing is not None:
                for key in self.keys(req)[:n]:
                    eng.routing.pop(key, None)
            return n

        eng._prefill_segment = prefill_segment
        eng._decode_all = decode
        eng._forward = recording_forward
        eng._stream_inject = inject_and_forget
        eng._finish_prefill = finish_and_copy
        return eng

    def flips(self, got, want, req, upto):
        """(The (MoE layer, token) top-k sets in which records ``got`` and
        ``want`` differ, those compared) over the tokens ``[0, upto]`` of
        ``req``'s sequence that both computed."""
        n = seen = 0
        for key in self.keys(req)[:upto + 1]:
            a, b = got.get(key), want.get(key)
            if a is not None and b is not None:
                n += int((a != b).any(axis=-1).sum())
                seen += a.shape[0]
        return n, seen


def _recording(eng, fn, force=None):
    """``fn()`` with ``eng``'s expert choices recorded when it is watched
    (:meth:`Routing.watch`), routed as the record ``force`` where given.
    Returns (fn's result, the record, or None)."""
    if not hasattr(eng, "routing"):
        return fn(), None
    eng.routing, eng.routing_force = {}, force
    try:
        return fn(), eng.routing
    finally:
        eng.routing, eng.routing_force = None, None


def phase_serving(cfg, params, kv_dtype="native", engine_cls=ServingEngine,
                  model="tinyllama-1.1b", max_new=32, label=None,
                  near_tie=False, routing=None):
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
    one. ``engine_cls``, ``model`` and ``label`` serve another model family
    (phase 10b); ``near_tie`` admits phase 6d's top-1 rule. With a
    :class:`Routing` (an MoE model) the engines' expert choices are
    recorded: a wave-4 request whose routing differs from wave 3's in some
    (layer, token) is held to ``REL_L2_MOE``, and wave 4 then runs again
    with wave 3's routing forced, which must hold ``REL_L2_REUSE``; wave 1's
    record and requests are kept in ``routing.wave1[kv_dtype]``. Returns
    (the repeated
    prompts, wave 1's first-token logits).
    """
    log(label or f"== phase {'4' if kv_dtype == 'native' else '6c'}: "
        f"ServingEngine, four waves, {kv_dtype} pool")
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, V, 1536)
    repeat = [np.concatenate([prefix, rng.integers(0, V, 513)]),
              np.concatenate([prefix, rng.integers(0, V, 513)]),
              rng.integers(0, V, 2049)]
    fresh = [np.concatenate([prefix, rng.integers(0, V, 512)])
             for _ in range(2)]
    sp = SamplingParams(max_new_tokens=max_new)
    engine = LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name=model, world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))

    def serving_engine(cache_engine):
        # one 512-token segment per request per step
        eng = engine_cls(cfg, params, max_batch=4, max_seq=2048 + 64,
                         cache_engine=cache_engine, prefill_chunk=512,
                         prefill_token_budget=3 * 512, kv_dtype=kv_dtype)
        if routing is not None:
            routing.watch(eng)
        # keep each request's first-token logits (the end of its prefill)
        eng.first_logits = {}
        finish = eng._finish_prefill

        def finish_and_keep(req, logits):
            eng.first_logits[req.request_id] = logits.float().clone()
            finish(req, logits)
        eng._finish_prefill = finish_and_keep
        return eng

    def wave(eng, name, prompts, force=None):
        t0 = time.perf_counter()
        reqs, record = _recording(eng, lambda: eng.generate(prompts, sp),
                                  force)
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
        return reqs, [eng.first_logits[r.request_id] for r in reqs], record

    eng = serving_engine(engine)
    w1, l1, rec1 = wave(eng, "wave 1", repeat)
    w2, l2, _ = wave(eng, "wave 2", repeat)
    w3, l3, rec3 = wave(eng, "wave 3", fresh)
    w4, l4, _ = wave(eng, "wave 4", fresh)
    flips = forced = None
    if routing is not None:
        routing.wave1[kv_dtype] = rec1, w1
        flips = [routing.flips(r.routing_seen[0], r3.routing_seen[0], r,
                               len(p) - 1)
                 for r, r3, p in zip(w4, w3, fresh)]
        if any(f for f, _ in flips):
            routing.swapped = 0
            _, forced, _ = wave(eng, "wave 4 again, routed as wave 3", fresh,
                                force=rec3)
            log(f"  wave 4 again: {routing.swapped} (layer, token) top-k "
                f"sets replaced by wave 3's")
    engine.close()
    ref, l_ref, _ = wave(serving_engine(None), "wave 3 without a cache tier",
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
            and _logits_agree("wave 4 vs wave 3", l4, l3, near_tie=near_tie,
                              flips=flips)
            and (forced is None or _logits_agree(
                "wave 4 routed as wave 3 vs wave 3", forced, l3,
                near_tie=near_tie))):
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


def paged_engine(cfg, params, engine_cls=PagedServingEngine, routing=None,
                 **kw):
    """A PagedServingEngine (page 64, 512-token prefill segments) that keeps
    what the checks read: ``prefill_logits[request_id]``, one ``(tokens
    sampled before, logits)`` per completed prefill (the first token; then
    one per resume after a preemption), ``injected_pages``, the number of
    pages written by ``_inject_pages``, ``injected``, its (blob, pages)
    calls, and ``decode_logits``, the logits of every batched decode step
    once ``keep_decode_logits`` is set. A :class:`Routing` watches it."""
    eng = engine_cls(cfg, params, page_size=PAGE, prefill_chunk=512, **kw)
    if routing is not None:
        routing.watch(eng)
    eng.prefill_logits = {}
    eng.injected_pages = 0
    eng.injected = []
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
        eng.injected.append((blob, list(pages)))
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


def paged_wave(eng, name, prompts, max_new, force=None):
    """Serve ``prompts`` greedily (routed as the record ``force`` where
    given). Returns (requests, first-token logits, pages injected from the
    cache tier, the engine's routing record or None)."""
    injected = eng.injected_pages
    t0 = time.perf_counter()
    reqs, record = _recording(
        eng, lambda: eng.generate(prompts,
                                  SamplingParams(max_new_tokens=max_new)),
        force)
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
    return reqs, first_logits, injected, record


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


def paged_tinyllama_waves(cfg, params, prompts, dense_logits, kv_dtype,
                          engine_cls=PagedServingEngine,
                          model="tinyllama-1.1b", max_new=32, long_new=96,
                          after_wave3=None, near_tie=False, routing=None):
    """The four waves over one arena dtype (``engine_cls`` and ``model``
    serve another family: phase 10c; ``after_wave3(engine)`` adds a check
    of wave 3's engine; ``near_tie`` admits phase 6d's top-1 rule). With a
    :class:`Routing` (an MoE model, phase 10b's dense wave-1 record in
    ``routing.wave1``) the bf16 arena's engines record their expert
    choices: where two computations of other shapes or kernels are compared,
    a request whose routing differs in some (layer, token) is held to
    ``REL_L2_MOE``, and the computation then runs again, on a fresh engine,
    with the reference's routing forced, which must hold ``REL_L2_REUSE``.
    Returns (wave 1's first-token logits, the decode step's profile)."""
    native = kv_dtype == "native"
    arena = "bf16" if native else "int8"
    log(f"  -- {arena} arena")
    tier = _tier(f"{model}-paged-{arena}", cfg)
    routing = routing if native else None
    kw = dict(max_batch=4, max_seq=PAGED_MAX_SEQ, cache_engine=tier,
              prefill_token_budget=3 * 512, kv_dtype=kv_dtype,
              engine_cls=engine_cls, routing=routing)
    n = len(prompts)
    hit = (len(prompts[0]) - 1) // PAGE * PAGE  # whole pages, last token out
    # an int8 arena re-quantizes what comes back from the tier
    tol = REL_L2_REUSE if native else REL_L2_INT8
    failed = []

    def flips(reqs, refs):
        """Routing flips per request pair up to the first token, from what
        each one's first-token logits saw, or None without a Routing."""
        if routing is None:
            return None
        return [routing.flips(r.routing_seen[0], s.routing_seen[0], r,
                              r.num_prompt_tokens - 1)
                for r, s in zip(reqs, refs)]

    def replayed(name, want_record, num_pages=256, new=max_new, **over):
        """A fresh engine's wave routed as ``want_record``."""
        routing.swapped = 0
        again = paged_engine(cfg, params, num_pages=num_pages,
                             **dict(kw, **over))
        reqs, logits, _, _ = paged_wave(again, name, prompts, new,
                                        force=want_record)
        log(f"  {name}: {routing.swapped} (layer, token) top-k sets "
            f"replaced by the reference's")
        return again, reqs, logits

    eng = paged_engine(cfg, params, num_pages=256, **kw)
    w1, l1, _, rec1 = paged_wave(eng, "wave 1 (fresh prompts)", prompts,
                                 max_new)
    if native:
        dense_rec, dense_reqs = (routing.wave1["native"] if routing
                                 else (None, None))
        f1 = flips(w1, dense_reqs)
        ok = _logits_agree("wave 1 vs the dense engine's wave 1", l1,
                           dense_logits, near_tie=near_tie, flips=f1)
        if ok and f1 and any(f for f, _ in f1):
            # the dense engine computed every token: no tier to replay
            _, _, again = replayed("wave 1 again, routed as the dense engine",
                                   dense_rec, cache_engine=None)
            ok = _logits_agree("wave 1 routed as the dense engine vs the "
                               "dense engine", again, dense_logits,
                               near_tie=near_tie)
        if not ok:
            failed.append("wave 1 disagrees with the dense engine")
    w2, _, inj2, _ = paged_wave(eng, "wave 2 (resident pages)", prompts,
                                max_new)
    d12 = _first_diverging(w1, w2)
    log(f"  wave 2: first differing token vs wave 1 {d12}")
    if not (all(r.cached_prefix_len == hit for r in w2) and inj2 == 0
            and d12 == [None] * n):
        failed.append("wave 2 was not served from resident pages alone, or "
                      "changed greedy tokens")
    profile = profile_decode_step(eng, prompts, arena)

    # a fresh engine on the same tier: nothing resident
    eng = paged_engine(cfg, params, num_pages=256, **kw)
    w3, l3, inj3, _ = paged_wave(eng, "wave 3 (retrieve + inject)",
                                 prompts, max_new)
    d13 = _first_diverging(w1, w3)
    log(f"  wave 3: first differing token vs wave 1 {d13}"
        f"{'' if native else ' (reported: the arena re-quantizes)'}")
    f3 = flips(w3, w1)
    ok = (all(r.cached_prefix_len == hit for r in w3)
          and inj3 == n * hit // PAGE
          and (d13 == [None] * n or not native)
          and _logits_agree("wave 3 vs wave 1", l3, l1, tol, native,
                            flips=f3))
    if after_wave3 is not None and not after_wave3(eng):
        failed.append("wave 3's injected pages differ from a dense slot's")
    if ok and f3 and any(f for f, _ in f3):
        _, _, again = replayed("wave 3 again, routed as wave 1", rec1)
        ok = _logits_agree("wave 3 routed as wave 1 vs wave 1", again, l1)
    if not ok:
        failed.append("wave 3 missed the tier or disagrees with wave 1")

    # wave 4: the same prompts with long_new new tokens, so that decode
    # crosses a page boundary; first on a roomy arena, then on one that
    # cannot hold three requests of 34 pages. Both engines are fresh, so
    # both restore the prompts from the tier.
    eng = paged_engine(cfg, params, num_pages=256, **kw)
    eng.keep_decode_logits = True
    ref, l_ref, _, rec_ref = paged_wave(
        eng, "wave 4 reference (roomy arena)", prompts, long_new)
    tight = paged_engine(cfg, params, num_pages=TIGHT_PAGES, **kw)
    w4, l4, _, _ = paged_wave(tight, f"wave 4 (arena of {TIGHT_PAGES - 1} "
                              f"pages)", prompts, long_new)
    d4 = _first_diverging(w4, ref)
    log(f"  wave 4: first differing token vs the roomy arena {d4} "
        f"(reported)")
    if sum(r.num_preemptions for r in w4) == 0:
        failed.append("wave 4 preempted nothing")
    if not _logits_agree("wave 4 vs the roomy arena, first token", l4, l_ref,
                         tol, native,
                         flips=flips(w4, ref)):
        failed.append("wave 4's first-token logits disagree")
    if len(eng.decode_logits) != long_new - 1:
        failed.append(f"the roomy arena decoded in {len(eng.decode_logits)} "
                      f"steps, not {long_new - 1}")

    def resumes(engine, reqs):
        """Each resume prefilled over the restored KV and sampled token k:
        (request, k, its logits, the roomy arena's decode step that sampled
        token k, the index of the resume), where the tokens before k equal
        the roomy arena's."""
        out = []
        for r, r_ref in zip(reqs, ref):
            for i, (k, logits) in enumerate(
                    engine.prefill_logits[r.request_id][1:], 1):
                same_past = r.output_tokens[:k] == r_ref.output_tokens[:k]
                log(f"  request {r.request_id} resumed at token {k} with "
                    f"{r.cached_prefix_len} cached tokens; tokens before the "
                    f"resume equal the roomy arena's: {same_past}")
                if not (same_past and r.cached_prefix_len >= hit):
                    failed.append(f"request {r.request_id} did not resume "
                                  f"where it was preempted")
                    continue
                out.append((r, k, logits,
                            eng.decode_logits[k - 1][r_ref.slot], i))
        return out

    back = resumes(tight, w4)
    f4 = (None if routing is None else
          [routing.flips(r.routing_seen[i], rec_ref, r,
                         r.num_prompt_tokens + k - 1)
           for r, k, _, _, i in back])
    ok = bool(back) and _logits_agree(
        f"wave 4 resumes at tokens {[k for _, k, *_ in back]} vs the roomy "
        f"arena", [g for _, _, g, _, _ in back], [w for *_, w, _ in back],
        tol,
        native, near_tie=near_tie and native, flips=f4)
    if ok and f4 and any(f for f, _ in f4):
        again, reqs, _ = replayed("wave 4 again (arena of "
                                  f"{TIGHT_PAGES - 1} pages), routed as the "
                                  f"roomy arena", rec_ref,
                                  num_pages=TIGHT_PAGES, new=long_new)
        forced = resumes(again, reqs)
        ok = bool(forced) and _logits_agree(
            "wave 4 resumes routed as the roomy arena vs the roomy arena",
            [g for _, _, g, _, _ in forced], [w for *_, w, _ in forced],
            near_tie=near_tie)
    tier.close()
    if not ok:
        failed.append("a preempted request's resume disagrees with the roomy "
                      "arena")
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
        reqs, first[arena], _, _ = paged_wave(
            eng, "two prompts, 16 new tokens", prompts, 16)
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


def profile_dense_decode_step(cfg, params, prompts, kv_dtype,
                              engine_cls=ServingEngine):
    """Bring three prompts to decode on a four-slot dense engine, then time
    and profile one batched decode step (the fourth row parked)."""
    eng = engine_cls(cfg, params, max_batch=4, max_seq=2048 + 64,
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


# ---------------------------------------------------------------- phase 9 ---

REMOTE_MODEL = "tinyllama-1.1b-remote"  # the tinyllama CacheGen schedule


def start_cache_server():
    """The port's cache server in a subprocess on a free port; fails the
    phase if it does not answer within 15 s."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "lmcache_tpu_torch.server",
                             "localhost", str(port), "cpu"])
    deadline = time.time() + 15
    while True:
        try:
            socket.create_connection(("localhost", port), timeout=0.5).close()
            return proc, f"lm://localhost:{port}"
        except OSError:
            if time.time() > deadline or proc.poll() is not None:
                proc.kill()
                proc.wait(timeout=10)
                raise SystemExit("the cache server did not answer in 15 s")
            time.sleep(0.05)


def remote_tier(url, cfg, **kw):
    return LMCacheEngine(
        LMCacheEngineConfig(local_device=None, remote_url=url,
                            remote_serde="cachegen", chunk_size=REMOTE_CHUNK,
                            **kw),
        LMCacheEngineMetadata(model_name=REMOTE_MODEL, world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))


def remote_store(url, cfg, tokens_np, prefix):
    """Instance A stores the CTX prefix (row 12, one launch a half); every
    container must equal the host C++ coder's; the card's quantization and
    CDF must equal the CPU's."""
    a = remote_tier(url, cfg)
    serializer = a.engine_.serializer
    encode, encode_ms = serializer.to_bytes_batch, []

    def timed_encode(blobs):
        t0 = time.perf_counter()
        out = encode(blobs)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    serializer.to_bytes_batch = timed_encode
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = a.store(tokens_np[:CTX], prefix, blocking=True)
    store_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launch_counts()
    keys = [a._make_key(h, "vllm")
            for h in prefix_chunk_hashes(tokens_np[:CTX], REMOTE_CHUNK)]
    wire = [a.engine_.connection.get(k.to_string()) for k in keys]
    a.close()
    host = cgs.CacheGenSerializer(
        LMCacheEngineConfig(local_device=None, remote_url="lm://localhost:1",
                            cachegen_device_encode="off"),
        LMCacheEngineMetadata(model_name=REMOTE_MODEL, world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    ref = host.to_bytes_batch(kv.chunk_blob(prefix, "vllm", REMOTE_CHUNK))
    equal = sum(w == r for w, r in zip(wire, ref))
    wire_bytes = sum(len(w) for w in wire)
    # what crossed from the card: every container's maxes, CDF tables,
    # lengths and coded bytes (its header was written on the host)
    d2h = sum(c.maxes.nbytes + c.cdf.nbytes + c.lens.nbytes + len(c.payload)
              for c in map(cgs._parse_container, wire))
    raw = prefix.numel() * prefix.element_size()
    log(f"  store: {n} chunks in {store_ms:.2f} ms, of which the encode "
        f"(to_bytes_batch: quantize, CDF, row 12, compaction, copies to the "
        f"host) {encode_ms[0]:.2f} ms and {n} PUTs the rest; launches "
        f"{launches}; wire "
        f"{wire_bytes / 1e6:.3f} MB for {raw / 1e6:.1f} MB of bf16 KV, "
        f"compression {raw / wire_bytes:.3f}x; device -> host "
        f"{d2h / 1e6:.3f} MB (coded bytes, lengths, CDF tables, maxes)")
    log(f"  containers equal to the host C++ coder's: {equal} of {len(wire)}")
    if n != STORE_CHUNKS or equal != STORE_CHUNKS:
        raise SystemExit("remote store: a container differs from the host "
                         "coder's")
    # the card's quantizer and CDF against the CPU's, on 8 chunks
    sub = torch.stack(kv.chunk_blob(prefix, "vllm", REMOTE_CHUNK)[:8])
    n, L, _, T, H, D = sub.shape
    cg = CacheGenConfig.from_model_name(REMOTE_MODEL, L)
    for hi, bins in enumerate((cg.key_bins, cg.value_bins)):
        x = sub[:, :, hi].reshape(n * L, T, H * D)
        b = torch.tensor(bins, dtype=torch.int32).repeat(n)
        sym, maxes = quant.quantize(x, b.cuda())
        sym_c, maxes_c = quant.quantize(x.cpu(), b)
        same = (torch.equal(sym.cpu(), sym_c)
                and torch.equal(maxes.cpu(), maxes_c)
                and torch.equal(quant.compute_cdf(sym).cpu(),
                                quant.compute_cdf(sym_c)))
        log(f"  {'KV'[hi]} half of 8 chunks: symbols, maxes and CDF tables "
            f"on the card equal the CPU's: {same}")
        if not same:
            raise SystemExit("the card's CDF differs from the CPU's")
    return launches, {"store_ms": store_ms, "encode_ms": encode_ms[0],
                      "wire_bytes": wire_bytes,
                      "raw_bytes": raw, "compression": raw / wire_bytes,
                      "device_to_host_bytes": d2h}


def remote_reuse_gate(url, cfg, params, tokens_np, full_logits):
    """Instance B (pipelined) serves the CTX + SUFFIX prompt: grouped
    inject (row 11, one launch a group), then the suffix prefill. Gates:
    the cached prefix; every group's symbols equal the host C++ decode of
    its containers; the slot equals retrieve() with the host decoder
    injected into a second slot. Returns the engine (its slot is read by
    the paged wave)."""
    b = remote_tier(url, cfg, pipelined_backend=True)
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=CTX + SUFFIX + 8,
                        cache_engine=b)
    kept, groups = {}, []
    finish, decode = eng._finish_prefill, rd.decode_streams

    def finish_and_keep(req, logits):
        kept[req.request_id] = logits.float().clone()
        finish(req, logits)

    def decode_and_keep(payload, offsets, cdf, n):
        out = decode(payload, offsets, cdf, n)
        groups.append((payload, offsets, cdf, n, out))
        return out

    eng._finish_prefill = finish_and_keep
    rd.decode_streams = decode_and_keep
    try:
        [req] = eng.generate([tokens_np], SamplingParams(max_new_tokens=1))
    finally:
        rd.decode_streams = decode
    b.engine_.flush()
    group_sizes = [g[1].numel() - 1 for g in groups]
    same_symbols = []
    for payload, offsets, cdf, n, out in groups:
        lens = np.diff(offsets.cpu().numpy())
        ref = range_coder.decode_streams(payload.cpu().numpy(), lens, n,
                                         quant.cdf_to_numpy(cdf))
        same_symbols.append(bool(np.array_equal(out.cpu().numpy(), ref)))
    off = remote_tier(url, cfg, cachegen_device_decode="off")
    blob, mask = off.retrieve(tokens_np[:CTX], return_tuple=False)
    off.close()
    other = 1 - req.slot
    eng._inject(blob, other, 0)
    same_kv = torch.equal(eng.kv_pool[:, :, req.slot, :, :CTX],
                          eng.kv_pool[:, :, other, :, :CTX])
    logits = kept[req.request_id]
    rel = ((logits - full_logits).norm() / full_logits.norm()).item()
    log(f"  reuse: cached_prefix_len {req.cached_prefix_len}; decode groups "
        f"of {group_sizes} streams; symbols equal the host C++ decode "
        f"{same_symbols}; slot KV equals retrieve() with the host decoder "
        f"injected into slot {other}: {same_kv}")
    log(f"  first-token logits against the full prefill's (CacheGen is "
        f"lossy, random-init KV its worst case; reported): rel_l2 {rel:.4e}, "
        f"top-1 {int(logits.argmax())} vs {int(full_logits.argmax())}")
    if not (req.cached_prefix_len >= CTX - 1
            and len(groups) == -(-STORE_CHUNKS // GROUP_CHUNKS)
            and all(same_symbols) and same_kv and int(mask.sum()) == CTX
            and bool(torch.isfinite(logits).all())):
        raise SystemExit("remote reuse: a gate failed")
    return eng, {"cached_prefix_len": req.cached_prefix_len,
                 "reuse_rel_l2": rel,
                 "same_top1": int(logits.argmax()) == int(
                     full_logits.argmax())}


def remote_stage_split(url, cfg, params, tokens, tokens_np):
    """bench.py:470-526's stages, one measured pass each, over the 62
    containers in the engine's groups of 16: mexist, fetch, parse, then for
    every group the host concat + upload, the row-11 decode, the host C++
    decode of the same group, dequantize + inject; then the suffix
    prefill over the injected slot."""
    ce = remote_tier(url, cfg)
    backend = ce.engine_
    keys = [ce._make_key(h, "vllm")
            for h in prefix_chunk_hashes(tokens_np[:CTX], REMOTE_CHUNK)]
    st = {}
    t0 = time.perf_counter()
    assert all(backend.batched_contains(keys))
    st["mexist_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    raw = [backend.connection.get(k.to_string()) for k in keys]
    st["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hcs = [backend.deserializer.from_bytes_host(b) for b in raw]
    st["parse_ms"] = (time.perf_counter() - t0) * 1e3
    ce.close()
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=CTX + SUFFIX + 8)
    for k in ("upload_ms", "decode_ms", "host_decode_ms", "dequant_inject_ms"):
        st[k] = 0.0
    up_bytes = 0
    for g0 in range(0, STORE_CHUNKS, GROUP_CHUNKS):
        group = hcs[g0:g0 + GROUP_CHUNKS]
        c0 = group[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lens = np.concatenate([c.lens.reshape(-1) for c in group])
        cdf = np.concatenate([c.cdf.reshape(-1, 33) for c in group])
        maxes = np.stack([c.maxes for c in group])
        payload = np.concatenate([np.frombuffer(c.payload, np.uint8)
                                  for c in group])
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        d_pay = torch.from_numpy(payload).cuda()
        d_offs = torch.from_numpy(offsets).cuda()
        d_cdf = torch.from_numpy(cdf.view(np.int16)).cuda()
        d_max = torch.from_numpy(maxes).cuda()
        half = torch.from_numpy(np.stack([
            c0.key_bins.astype(np.int32) // 2 - 1,
            c0.value_bins.astype(np.int32) // 2 - 1]).astype(
                np.float32)).cuda()
        torch.cuda.synchronize()
        st["upload_ms"] += (time.perf_counter() - t0) * 1e3
        up_bytes += payload.nbytes + cdf.nbytes + offsets.nbytes + maxes.nbytes
        t0 = time.perf_counter()
        sym = rd.decode_streams(d_pay, d_offs, d_cdf, c0.g * c0.T)
        torch.cuda.synchronize()
        st["decode_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        range_coder.decode_streams(payload, lens, c0.g * c0.T, cdf)
        st["host_decode_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        blob = cgs.symbols_to_blob(
            sym, d_max, half, nchunks=len(group), L=c0.L, H=c0.H, D=c0.D,
            T=c0.T, g=c0.g, N=c0.N, fmt="vllm", dtype=c0.dtype, tok_start=0,
            tok_stop=len(group) * c0.T)
        eng._inject(blob, 0, g0 * REMOTE_CHUNK)
        torch.cuda.synchronize()
        st["dequant_inject_ms"] += (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    llama.forward(params, cfg, tokens[:, CTX:],
                  torch.full((1,), CTX, dtype=torch.int32, device="cuda"),
                  eng._slot_view(0), last_logit_only=True)
    torch.cuda.synchronize()
    st["suffix_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    log("  stages (one pass each, ms; groups of 16 summed): " + ", ".join(
        f"{k[:-3]} {v:.2f}" for k, v in st.items())
        + f"; host -> device {up_bytes / 1e6:.3f} MB")
    st["host_to_device_bytes"] = up_bytes
    return st


def phase_remote(cfg, params, ttft_full_ms):
    """Phase 9: reuse across engine instances through the cache server.
    Returns (launch counts by sub-phase, the phase's numbers)."""
    log(f"== phase 9: remote CacheGen reuse, tinyllama-1.1B, CTX {CTX} + "
        f"SUFFIX {SUFFIX}, chunks of {REMOTE_CHUNK}, through the port's cache "
        f"server")
    S = CTX + SUFFIX
    tokens_np = np.random.default_rng(0).integers(0, cfg.vocab_size, S,
                                                  dtype=np.int32)
    tokens = torch.as_tensor(tokens_np, device="cuda").long()[None]
    logits, cache = llama.forward(
        params, cfg, tokens, torch.zeros(1, dtype=torch.int32, device="cuda"),
        llama.new_kv_cache(cfg, 1, S), last_logit_only=True)
    full_logits = logits[0, -1].float()
    prefix = llama.cache_to_blob(cache, 0, CTX)
    launches, out = {}, {}
    proc, url = start_cache_server()
    try:
        launches["remote store"], out["store"] = remote_store(
            url, cfg, tokens_np, prefix)
        del cache, prefix
        dense, out["gate"] = remote_reuse_gate(url, cfg, params, tokens_np,
                                               full_logits)

        # timed: one engine as a user runs it (max_batch 1), each request a
        # new 512-token question on the stored document
        b = remote_tier(url, cfg, pipelined_backend=True)
        eng = ServingEngine(cfg, params, max_batch=1, max_seq=S + 8,
                            cache_engine=b)
        rng = np.random.default_rng(9)
        sp = SamplingParams(max_new_tokens=1)

        def question():
            return np.concatenate([tokens_np[:CTX], rng.integers(
                0, cfg.vocab_size, SUFFIX, dtype=np.int32)])

        def serve():
            [r] = eng.generate([question()], sp)
            torch.cuda.synchronize()
            b.engine_.flush()  # the store-back of the new suffix
            if r.cached_prefix_len != CTX:
                raise SystemExit(f"remote reuse: {r.cached_prefix_len} "
                                 f"cached, not {CTX}")
            return r.ttft_s * 1e3

        serve()  # warm-up
        reset_launch_counts()
        ttft = sorted(serve() for _ in range(3))
        launches["remote reuse"] = read_launch_counts()
        log(f"  TTFT remote {ttft[0]:.2f} ms best of 3, median {ttft[1]:.2f} "
            f"ms (each request a new suffix); TTFT full {ttft_full_ms:.2f} ms "
            f"(phase 3): ratio {ttft_full_ms / ttft[0]:.3f}x; launches of the "
            f"three requests {launches['remote reuse']}")
        out["ttft_remote_ms"], out["ttft_remote_median_ms"] = ttft[0], ttft[1]
        out["ttft_full_ms"] = ttft_full_ms
        out["profile"] = profile_window(
            "remote reuse request (fetch, grouped decode + inject, suffix)",
            lambda: eng.generate([question()], sp))
        b.engine_.flush()
        b.close()
        del eng
        out["stages"] = remote_stage_split(url, cfg, params, tokens,
                                           tokens_np)

        # the paged engine over the same server (page 64, chunk 256)
        tier = remote_tier(url, cfg, pipelined_backend=True)
        peng = paged_engine(cfg, params, max_batch=1, max_seq=S + 8,
                            num_pages=S // PAGE + 8, cache_engine=tier)
        written = []
        inject = peng._inject_pages

        def inject_and_keep(blob, pages):
            written.extend(pages)
            inject(blob, pages)

        peng._inject_pages = inject_and_keep
        reset_launch_counts()
        [r], _, n_pages, _ = paged_wave(
            peng, "paged wave over the remote tier", [tokens_np], 1)
        launches["remote paged"] = read_launch_counts()
        tier.close()
        pages = peng._read_pages(written)[:, :, :CTX]
        same = torch.equal(pages, llama.cache_to_blob(dense.kv_pool, 0, CTX))
        log(f"  paged: {n_pages} pages injected in groups; the first {CTX} "
            f"tokens of the pages equal the dense slot's KV: {same}; "
            f"launches {launches['remote paged']}")
        if not (same and r.cached_prefix_len >= CTX):
            raise SystemExit("remote paged wave: the pages differ from the "
                             "dense slot")
        dense.cache_engine.close()
        del dense, peng
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    torch.cuda.empty_cache()
    return launches, out


# the reference geometry of bench.py:636-641: layers, KV heads, head dim,
# chunks of 256 tokens
CODEC_GEOMETRY = (32, 8, 128, 8)


def phase_codec_throughput():
    """Rows 12 and 11 alone, the host C++ coder both ways and the serde end
    to end at the reference geometry of bench.py:636-641 (32 layers x 8 KV
    heads x 128, bf16, 8 chunks of 256 tokens, the longchat-7b-16k
    schedule: 524288 streams of 256 symbols), each as GB/s of the bf16 KV
    it codes."""
    L, H, D, n = CODEC_GEOMETRY
    log(f"== phase 9b: codec throughput, {L} L x {H} H x {D} D bf16, {n} "
        f"chunks of 256 tokens (lmsys/longchat-7b-16k schedule)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    blobs = [torch.randn((L, 2, 256, H, D), generator=gen,
                         device="cuda").bfloat16() for _ in range(n)]
    raw = sum(b.numel() * 2 for b in blobs)
    cg = CacheGenConfig.from_model_name("lmsys/longchat-7b-16k", L)
    stacked = torch.stack(blobs)
    halves = []
    for hi, bins in enumerate((cg.key_bins, cg.value_bins)):
        sym, _ = quant.quantize(
            stacked[:, :, hi].reshape(n * L, 256, H * D),
            torch.tensor(bins, dtype=torch.int32, device="cuda").repeat(n))
        halves.append(sym.transpose(1, 2).reshape(-1, 256))
    streams = torch.cat(halves)
    cdf = quant.stream_cdf(streams)
    del stacked, halves
    enc_ms = cuda_ms(lambda: re_.encode_streams_raw(streams, cdf), iters=5)
    out, lens = re_.encode_streams_raw(streams, cdf)
    payload = re_.compact(out, lens)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                         lens.long().cumsum(0)])
    dec_ms = cuda_ms(lambda: rd.decode_streams(payload, offsets, cdf, 256),
                     iters=5)
    sym_h, cdf_h = streams.cpu().numpy(), quant.cdf_to_numpy(cdf)
    pay_h, lens_h = payload.cpu().numpy(), lens.cpu().numpy()
    host_enc = wall_best(lambda: range_coder.encode_streams(sym_h, cdf_h),
                         n=1)
    host_dec = wall_best(lambda: range_coder.decode_streams(
        pay_h, lens_h, 256, cdf_h), n=1)
    ref_pay, ref_lens = range_coder.encode_streams(sym_h, cdf_h)
    same = (np.array_equal(ref_lens, lens_h) and ref_pay == pay_h.tobytes()
            and torch.equal(rd.decode_streams(payload, offsets, cdf, 256),
                            streams))
    meta = LMCacheEngineMetadata(model_name="lmsys/longchat-7b-16k",
                                 world_size=1, worker_id=0, fmt="vllm",
                                 dtype="bfloat16")
    config = LMCacheEngineConfig(local_device=None,
                                 remote_url="lm://localhost:1",
                                 remote_serde="cachegen")
    ser = cgs.CacheGenSerializer(config, meta)
    de = cgs.CacheGenDeserializer(config, meta)
    bss = ser.to_bytes_batch(blobs)
    ser_ms = wall_best(lambda: ser.to_bytes_batch(blobs), n=2)
    de_ms = wall_best(lambda: cgs.finish_host_chunks(
        [de.from_bytes_host(b) for b in bss]), n=2)
    rates = {"row 12 alone": enc_ms, "row 11 alone": dec_ms,
             "host C++ encode": host_enc, "host C++ decode": host_dec,
             "serde to_bytes_batch": ser_ms,
             "serde parse + finish_host_chunks": de_ms}
    log(f"  {streams.shape[0]} streams of 256 symbols, {raw / 1e6:.1f} MB of "
        f"bf16 KV, {int(lens.sum()) / 1e6:.3f} MB coded; kernels equal the "
        f"host coder: {same}")
    for k, ms in rates.items():
        log(f"  {k}: {ms:.3f} ms, {raw / ms / 1e6:.2f} GB/s of bf16 KV")
    if not same:
        raise SystemExit("codec throughput: the kernels differ from the host "
                         "coder")
    return {k: {"ms": ms, "gb_s": raw / ms / 1e6} for k, ms in rates.items()}


# --------------------------------------------------------------- phase 10 ---

MLA_MODEL = "deepseek-v2-lite"


def _mla_tier(name):
    return LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name=name, world_size=1, worker_id=0,
                              fmt="vllm", dtype=MLA_CFG.dtype))


def mla_bench(cfg, params, reps):
    """10a: the bench shape through ``mla.forward``: full prefill of CTX +
    SUFFIX tokens, store of the CTX prefix's latents into the "cuda" tier,
    retrieve, inject, suffix prefill. Returns (the phase's numbers, the
    prompt, the full prefill's last logits, the stored prefix blob)."""
    log(f"  -- 10a: prefill -> store -> retrieve -> inject -> suffix "
        f"prefill, CTX {CTX} + SUFFIX {SUFFIX}")
    S = CTX + SUFFIX
    tokens_np = np.random.default_rng(10).integers(0, cfg.vocab_size, S,
                                                   dtype=np.int32)
    tokens = torch.as_tensor(tokens_np, device="cuda").long()[None]
    engine = _mla_tier(MLA_MODEL)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefill_full():
        logits, cache = mla.forward(params, cfg, tokens, zero,
                                    mla.new_latent_cache(cfg, 1, S),
                                    last_logit_only=True)
        return logits[0, -1], cache

    def prefill_reuse():
        blob, mask = engine.retrieve(tokens_np, return_tuple=False)
        if int(mask.sum()) != CTX:
            raise SystemExit(f"expected {CTX} hits, got {int(mask.sum())}")
        cache = mla.blob_into_cache(mla.new_latent_cache(cfg, 1, S), blob)
        logits, _ = mla.forward(
            params, cfg, tokens[:, CTX:],
            torch.full((1,), CTX, dtype=torch.int32, device="cuda"), cache,
            last_logit_only=True)
        return logits[0, -1]

    full_logits, cache = prefill_full()
    prefix = mla.cache_to_blob(cache, 0, CTX).clone()
    n_chunks = engine.store(tokens_np[:CTX], prefix)
    del cache
    reuse_logits = prefill_reuse()
    torch.cuda.synchronize()
    log(f"  stored {n_chunks} chunks of latent blobs "
        f"{list(prefix.shape)} ({prefix.numel() * 2 / 1e6:.1f} MB)")
    # random MoE weights may leave the logits near-flat: phase 6d's rule
    got, want = reuse_logits.float(), full_logits.float()
    rel = ((got - want).norm() / want.norm()).item()
    rule = ("same top-1" if int(got.argmax()) == int(want.argmax())
            else "near tie")
    if not (bool(torch.isfinite(got).all()) and _logits_agree(
            f"reuse vs full prefill ({rule})", [got], [want],
            near_tie=True)):
        raise SystemExit("mla: reuse logits disagree with the full prefill")
    t_full = wall_best(lambda: prefill_full(), n=reps)
    t_reuse = wall_best(prefill_reuse, n=reps)
    log(f"  TTFT full {t_full:.2f} ms, TTFT reuse {t_reuse:.2f} ms, ratio "
        f"{t_full / t_reuse:.2f}x (best of {reps} after a warm-up)")
    profile = [profile_window("mla full prefill", lambda: prefill_full()),
               profile_window("mla reuse request", prefill_reuse)]
    engine.close()
    return ({"ttft_full_ms": t_full, "ttft_reuse_ms": t_reuse,
             "speedup": t_full / t_reuse, "reuse_rel_l2": rel,
             "reuse_rule": rule, "profile": profile},
            tokens_np, full_logits.float(), prefix)


def mla_dense_slot(cfg, blob, native):
    """What the dense engine's inject puts into a slot, read back as a
    wire blob."""
    n = blob.shape[2]
    if native:
        cache = mla.blob_into_cache(mla.new_latent_cache(cfg, 1, n), blob)
        return mla.cache_to_blob(cache, 0, n)
    cache = mla.blob_into_quantized_cache(
        mla.new_quantized_latent_cache(cfg, 1, n), blob)
    return mla.quantized_cache_to_blob(cache, 0, n, mla.torch_dtype(cfg))


def mla_row9(cfg, params, prompt, kv_dtype):
    """10d: kernel row 9 has no serving path (as in the JAX package): the
    last prefill segment of a paged request runs again, on a copy of the
    arena, with the paged forward's attention bound to the one-page-per-step
    kernel; its logits are held to row 10's."""
    quant = kv_dtype == "int8"
    eng = MLAPagedServingEngine(cfg, params, page_size=PAGE, max_batch=1,
                                max_seq=MLA_SERVE_SEQ, num_pages=NP_MLA + 2,
                                prefill_chunk=512, kv_dtype=kv_dtype)
    kept = {}
    segment = eng._prefill_segment

    def segment_and_row9(req, pos, seg):
        logits = segment(req, pos, seg)
        if pos + len(seg) == len(req.all_tokens):
            pool = eng.kv_pool
            pool = ({k: v.clone() for k, v in pool.items()} if quant
                    else pool.clone())
            through_row_10 = (mla.paged_latent_attention_dma,
                              mla.quantized_paged_latent_attention_dma)
            mla.paged_latent_attention_dma = pla.paged_latent_attention
            mla.quantized_paged_latent_attention_dma = (
                pla.quantized_paged_latent_attention)
            try:
                out, _ = mla.forward_paged(
                    eng.params, cfg,
                    torch.as_tensor(seg, dtype=torch.long,
                                    device="cuda")[None],
                    torch.tensor([pos], dtype=torch.int32, device="cuda"),
                    pool, eng._tables(eng.page_tables[req.slot:req.slot + 1]),
                    last_logit_only=True)
            finally:
                (mla.paged_latent_attention_dma,
                 mla.quantized_paged_latent_attention_dma) = through_row_10
            kept["row 9"] = out[0, -1].float()
            kept["row 10"] = logits.float()
        return logits

    eng._prefill_segment = segment_and_row9
    eng.generate([prompt], SamplingParams(max_new_tokens=1))
    return _logits_agree(f"{kv_dtype} arena, last prefill segment through "
                         f"row 9 vs row 10", [kept["row 9"]],
                         [kept["row 10"]], near_tie=True)


def mla_remote(cfg, params, tokens_np, prefix, full_logits, kv_wire_bytes):
    """10e: the latent prefix through the cache server with the CacheGen
    serde (single-stream N = 1 containers, ``CacheGenConfig.for_latent``):
    a store by instance A, every container equal to the host C++ coder's;
    a fresh pipelined ``MLAServingEngine`` serves the prompt from it, every
    decoded group's symbols equal to the host decode. The first-token
    logits against the full prefill's (CacheGen is lossy) and the wire
    bytes against phase 9's K/V are reported."""
    log("  -- 10e: latent CacheGen through the cache server")
    name = f"{MLA_MODEL}-remote"

    def tier(**kw):
        return LMCacheEngine(
            LMCacheEngineConfig(local_device=None, remote_url=url,
                                remote_serde="cachegen",
                                chunk_size=REMOTE_CHUNK, **kw),
            LMCacheEngineMetadata(model_name=name, world_size=1, worker_id=0,
                                  fmt="vllm", dtype=cfg.dtype))

    proc, url = start_cache_server()
    try:
        a = tier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = a.store(tokens_np[:CTX], prefix, blocking=True)
        store_ms = (time.perf_counter() - t0) * 1e3
        keys = [a._make_key(h, "vllm")
                for h in prefix_chunk_hashes(tokens_np[:CTX], REMOTE_CHUNK)]
        wire = [a.engine_.connection.get(k.to_string()) for k in keys]
        a.close()
        host = cgs.CacheGenSerializer(
            LMCacheEngineConfig(local_device=None,
                                remote_url="lm://localhost:1",
                                cachegen_device_encode="off"),
            LMCacheEngineMetadata(model_name=name, world_size=1,
                                  worker_id=0, fmt="vllm", dtype=cfg.dtype))
        ref = host.to_bytes_batch(kv.chunk_blob(prefix, "vllm",
                                                REMOTE_CHUNK))
        equal = sum(w == r for w, r in zip(wire, ref))
        wire_bytes = sum(len(w) for w in wire)
        raw = prefix.numel() * prefix.element_size()

        b = tier(pipelined_backend=True)
        eng = MLAServingEngine(cfg, params, max_batch=1,
                               max_seq=CTX + SUFFIX + 8, cache_engine=b)
        kept, groups = {}, []
        finish, decode = eng._finish_prefill, rd.decode_streams

        def finish_and_keep(req, logits):
            kept[req.request_id] = logits.float().clone()
            finish(req, logits)

        def decode_and_keep(payload, offsets, cdf, n_sym):
            out = decode(payload, offsets, cdf, n_sym)
            groups.append((payload, offsets, cdf, n_sym, out))
            return out

        eng._finish_prefill = finish_and_keep
        rd.decode_streams = decode_and_keep
        try:
            t0 = time.perf_counter()
            [req] = eng.generate([tokens_np], SamplingParams(max_new_tokens=1))
            torch.cuda.synchronize()
            serve_ms = (time.perf_counter() - t0) * 1e3
        finally:
            rd.decode_streams = decode
        b.engine_.flush()
        b.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    same_symbols = []
    for payload, offsets, cdf, n_sym, out in groups:
        lens = np.diff(offsets.cpu().numpy())
        host_sym = range_coder.decode_streams(payload.cpu().numpy(), lens,
                                              n_sym, quant.cdf_to_numpy(cdf))
        same_symbols.append(bool(np.array_equal(out.cpu().numpy(),
                                                host_sym)))
    logits = kept[req.request_id]
    rel = ((logits - full_logits).norm() / full_logits.norm()).item()
    log(f"  store: {n} chunks in {store_ms:.2f} ms; wire {wire_bytes / 1e6:.3f}"
        f" MB for {raw / 1e6:.1f} MB of bf16 latents, compression "
        f"{raw / wire_bytes:.3f}x (phase 9's tinyllama K/V of the same "
        f"{CTX} tokens: {kv_wire_bytes / 1e6:.3f} MB); containers equal to "
        f"the host C++ coder's: {equal} of {len(wire)}")
    log(f"  served by a fresh pipelined engine in {serve_ms:.2f} ms: "
        f"cached_prefix_len {req.cached_prefix_len}; decode groups of "
        f"{[g[1].numel() - 1 for g in groups]} streams; symbols equal the "
        f"host C++ decode {same_symbols}")
    log(f"  first-token logits against the full prefill's (lossy; "
        f"reported): rel_l2 {rel:.4e}, top-1 {int(logits.argmax())} vs "
        f"{int(full_logits.argmax())}")
    if not (n == STORE_CHUNKS and equal == STORE_CHUNKS and groups
            and all(same_symbols) and req.cached_prefix_len >= CTX - 1
            and bool(torch.isfinite(logits).all())):
        raise SystemExit("mla remote: a gate failed")
    return {"store_ms": store_ms, "wire_bytes": wire_bytes, "raw_bytes": raw,
            "compression": raw / wire_bytes, "kv_wire_bytes": kv_wire_bytes,
            "serve_ms": serve_ms, "cached_prefix_len": req.cached_prefix_len,
            "reuse_rel_l2": rel,
            "same_top1": int(logits.argmax()) == int(full_logits.argmax())}


def phase_mla(kv_wire_bytes, reps=2):
    """Phase 10: DeepSeek-V2-Lite at full width and depth with random bf16
    weights. Returns (launch counts by sub-phase, the phase's numbers)."""
    cfg = MLA_CFG
    log(f"== phase 10: DeepSeek-V2-Lite ({cfg.n_layers} layers, "
        f"{cfg.n_heads} heads, latent {cfg.latent_dim} = "
        f"{cfg.kv_lora_rank} + {cfg.qk_rope_head_dim}, "
        f"{cfg.n_routed_experts} + {cfg.n_shared_experts} experts, top "
        f"{cfg.n_experts_per_tok}), random weights, full width and depth")
    t0 = time.perf_counter()
    params = mla.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for block in (
        [params] + [params[k] for k in ("dense_layers", "moe_layers")])
        for t in block.values() if isinstance(t, torch.Tensor))
    log(f"  weights {n_bytes / 1e9:.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, out = {}, {"weights_bytes": n_bytes}
    reset_launch_counts()
    out["bench"], tokens_np, full_logits, prefix = mla_bench(cfg, params,
                                                             reps)
    launches["mla bench"] = read_launch_counts()

    first = {}
    routing = Routing()
    for kv_dtype in ("native", "int8"):
        reset_launch_counts()
        with routing:
            prompts, first[kv_dtype] = phase_serving(
                cfg, params, kv_dtype, engine_cls=MLAServingEngine,
                model=MLA_MODEL, max_new=8, near_tie=True, routing=routing,
                label=f"  -- 10b: MLAServingEngine, four waves, {kv_dtype} "
                      f"pool")
        launches[f"mla serving {kv_dtype}"] = read_launch_counts()
        torch.cuda.empty_cache()
    if not _logits_agree("int8 pool vs native pool, wave 1", first["int8"],
                         first["native"], REL_L2_INT8, same_top1=False):
        raise SystemExit("mla: the int8 pool's logits left the native "
                         "pool's")
    out["dense_decode_profile"] = profile_dense_decode_step(
        cfg, params, prompts, "native", engine_cls=MLAServingEngine)

    log("  -- 10c: MLAPagedServingEngine (page 64), four waves per arena")
    paged_first, out["paged_decode_profiles"] = {}, []
    for kv_dtype, arena in (("native", "bf16"), ("int8", "int8")):
        native = kv_dtype == "native"

        def injected_equal_dense(eng, native=native):
            same = [torch.equal(eng._read_pages(pages),
                                mla_dense_slot(cfg, blob, native))
                    for blob, pages in eng.injected]
            log(f"  wave 3: {len(same)} injected chunks; the pages read back "
                f"equal the dense pool's slot of the same chunk: "
                f"{all(same)}")
            return bool(same) and all(same)

        reset_launch_counts()
        with routing:
            paged_first[arena], profile = paged_tinyllama_waves(
                cfg, params, prompts, first["native"], kv_dtype,
                engine_cls=MLAPagedServingEngine, model=MLA_MODEL, max_new=8,
                long_new=66, after_wave3=injected_equal_dense, near_tie=True,
                routing=routing)
        launches[f"mla paged {arena}"] = read_launch_counts()
        out["paged_decode_profiles"].append(profile)
        torch.cuda.empty_cache()
    if not _logits_agree("int8 arena vs bf16 arena, wave 1",
                         paged_first["int8"], paged_first["bf16"],
                         REL_L2_INT8, same_top1=False):
        raise SystemExit("mla: the int8 arena's logits left the bf16 "
                         "arena's")

    log("  -- 10d: kernel row 9 (one page per step) on the paged forward")
    reset_launch_counts()
    # 2000 tokens: the last segment is a prefill of 464 rows a head
    ok = all([mla_row9(cfg, params, prompts[0][:2000], kv_dtype)
              for kv_dtype in ("native", "int8")])
    launches["mla row 9"] = read_launch_counts()
    if not ok:
        raise SystemExit("mla: row 9's logits disagree with row 10's")

    reset_launch_counts()
    out["remote"] = mla_remote(cfg, params, tokens_np, prefix, full_logits,
                               kv_wire_bytes)
    launches["mla remote"] = read_launch_counts()
    del prefix
    torch.cuda.empty_cache()
    blend_launches, out["blend"] = phase_blend(
        cfg, params, True, routing=routing,
        engines=[(MLAServingEngine, {}),
                 (MLAPagedServingEngine, {"page_size": PAGE,
                                          "num_pages": NP_BLEND})])
    launches.update(blend_launches)
    del params
    torch.cuda.empty_cache()
    return launches, out


# ------------------------------------ phase 11: row 13, the ablation tool ---

def phase_ablation():
    """Kernel row 13 at the JAX tool's geometry (Llama-3-8B's attention, B
    1, H_kv 8, G 4, D 128, S 8192, bq 256, bk 1024), through the port's
    ablation tool: its six variants run once with every count at 0 (the
    path); each output is held against its plain version (row 1's bf16 gate;
    ``mxu_only``'s unnormalized sums, values above 64 here, by relative L2
    alone), the variants of row 1's function also against row 1; then each
    variant is timed beside its bound, its plain version and one library
    call (SDPA with the flash backend for row 1's function, SDPA over the
    live blocks' mask for ``no_mask``, none for ``mxu_only``). Returns
    (launch counts, {kernel: rows}, {kernel: worst max abs error}, the
    phase's numbers)."""
    geo = bench_mfu.geometry(False)
    bq, bk, G, S = geo["bq"], geo["bk"], geo["G"], geo["S"]
    log(f"== phase 11: row 13, the prefill ablation variants (B {geo['B']}, "
        f"H_kv {geo['Hkv']}, G {G}, D {geo['D']}, S {S}, bq {bq}, bk {bk})")
    x = bench_mfu.make_inputs(geo, bq, "cuda")
    qo, kl = x["q_offset"].tolist(), x["kv_len"].tolist()
    reset_launch_counts()
    outs = {v[0]: bench_mfu.call(v, x, bq, bk) for v in bench_mfu.VARIANTS}
    torch.cuda.synchronize()
    launches = {"row 13 ablation": read_launch_counts()}
    ref1 = bench_mfu.row1(x).transpose(1, 2)  # [B, H, S, D]
    worst = {"variant_attention": 0.0, "pipelined_attention": 0.0}
    rows = {"variant_attention": [], "pipelined_attention": []}
    t_row1 = cuda_ms(lambda: bench_mfu.row1(x), iters=5)
    t_sdpa = cuda_ms(bench_mfu.sdpa_flash(x, G), iters=5)
    log(f"  row 1 flash_attention {t_row1:.4f} ms, SDPA (flash backend, K/V "
        f"expanded over the heads) {t_sdpa:.4f} ms")
    for variant in bench_mfu.VARIANTS:
        name, mode = variant[0], variant[1]
        kernel = ("pipelined_attention" if variant[3]
                  else "variant_attention")
        out, want = outs[name], bench_mfu.plain(variant, x, bq, bk)
        torch.cuda.synchronize()
        if mode == "mxu_only":
            diff = out.float() - want.float()
            rel = (diff.norm() / want.float().norm()).item()
            max_abs = diff.abs().max().item()
            ok = bool(torch.isfinite(out.float()).all()) and (
                rel <= REL_L2_KERNEL)
            log(f"  {kernel} | {name}: out {tuple(out.shape)} max_abs_err "
                f"{max_abs:.3e} rel_l2 {rel:.3e} (unnormalized sums: "
                f"tolerance rel_l2 <= {REL_L2_KERNEL}) "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(f"{kernel} {name} disagrees with its plain "
                                 f"version")
        else:
            max_abs = hold_against_plain(kernel, name, out, want)
        worst[kernel] = max(worst[kernel], max_abs)
        row1_err = None
        if name in bench_mfu.ROW1_FUNCTION:
            row1_err = hold_against_plain(kernel, f"{name} vs row 1",
                                          out[:, :, :S], ref1)
        del want
        flops, nbytes = bench_mfu.work(variant, geo, qo, kl, bq, bk)
        bound_ms, bound_by = bench_mfu.bound_ms(flops, nbytes)
        ms = cuda_ms(lambda: bench_mfu.call(variant, x, bq, bk), iters=5)
        plain_ms = cuda_ms(lambda: bench_mfu.plain(variant, x, bq, bk),
                           iters=1, warmup=1)
        library_ms, library = None, "none (no single call)"
        if name in bench_mfu.ROW1_FUNCTION:
            library_ms, library = t_sdpa, "SDPA flash"
        elif mode == "no_mask":
            library_ms = ablation_sdpa_live_blocks(x, G, bq, bk)
            library = "SDPA over the live blocks' mask"
        row = {"shape": name, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "flops": flops,
               "tflops": flops / ms / 1e9,
               "peak_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
               "row1_ms": t_row1, "sdpa_ms": t_sdpa,
               "max_abs_err_row1": row1_err}
        rows[kernel].append(row)
        log(f"  {kernel} | {name}: kernel {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, {100 * row['peak_share']:.2f} % "
            f"of peak), bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms, library {library}"
            + (f" {library_ms:.4f} ms" if library_ms is not None else ""))
    del outs, x
    torch.cuda.empty_cache()
    return launches, rows, worst, {"row1_ms": t_row1, "sdpa_ms": t_sdpa}


def ablation_sdpa_live_blocks(x, G, bq, bk):
    """One SDPA call computing ``no_mask``: softmax attention over every
    key of the live blocks, as a boolean mask [Tp, S] (K/V expanded over
    the heads outside the timed call)."""
    q = x["qh"]
    k = x["k"].repeat_interleave(G, dim=1)
    v = x["v"].repeat_interleave(G, dim=1)
    Tp, S = q.shape[2], k.shape[2]
    qpos_max = (torch.arange(Tp, device="cuda") // bq + 1) * bq - 1
    kb = torch.arange(S, device="cuda") // bk
    mask = (kb[None, :] * bk <= qpos_max[:, None])[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask), iters=5)


# ------------------------------------------------- phase 12: CacheBlend ---

# RAG-shaped prompts: retrieved documents of 1024 tokens, then a question
BLEND_DOCS, BLEND_DOC_LEN, BLEND_QUESTION = 8, 1024, 128
BLEND_T = BLEND_DOCS * BLEND_DOC_LEN + BLEND_QUESTION  # 8320
BLEND_RATIO = 0.15  # the engines' default recompute ratio
BLEND_NEW = 4  # tokens each engine request decodes
NP_BLEND = -(-(BLEND_T + 64 + 1) // PAGE) + 1  # the paged engines' arena


def blend_chunks(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in [BLEND_DOC_LEN] * BLEND_DOCS + [BLEND_QUESTION]]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_blend(cfg, params, mla_model, routing=None, engines=()):
    """CacheBlend at full width and depth on a RAG-shaped prompt (8
    retrieved documents of 1024 tokens, then a 128-token question; T 8320).

    The chunks are stored through the blender (each a standalone prefill,
    ``llama.forward`` / ``mla.forward``: rows 1 / 8), then blended from the
    "cuda" tier. Gates: at ``recompute_ratio`` 1.0 the logits hold the full
    prefill's of the concatenated prompt within ``REL_L2_REUSE`` with the
    same top-1 (MLA: phase 10's rule, ``Routing`` counting the (layer, token)
    expert sets the two computations pick differently; with flips the
    request is held to ``REL_L2_MOE`` and its blend run again with the full
    prefill's experts forced must hold ``REL_L2_REUSE``); at ratio 0.15 the
    logits are closer to the full prefill's than naive reuse (ratio 0: only
    the last token recomputed); a second blend has no misses; each engine
    of ``engines`` (classes and their kwargs) admits a ``context_chunks``
    request whose first token is the blender's, and decodes. Reported: TTFT
    of the blend request in the first engine against a full prefill of the
    same T, the tokens recomputed, a ``profile_window`` of one blend
    admission. Returns (launch counts by engine, the phase's numbers)."""
    name = "mla" if mla_model else "dense"
    model = mla if mla_model else llama
    log(f"== phase 12{'b' if mla_model else 'a'}: CacheBlend, "
        f"{'DeepSeek-V2-Lite' if mla_model else 'tinyllama-1.1B'}, "
        f"{BLEND_DOCS} documents of {BLEND_DOC_LEN} tokens + a "
        f"{BLEND_QUESTION}-token question (T {BLEND_T}), ratio {BLEND_RATIO}")
    chunks = blend_chunks(cfg.vocab_size, 12)
    full = np.concatenate(chunks)
    tier = LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name=f"{name}-blend", world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    cls = blend_mla.MLACacheBlender if mla_model else blend.CacheBlender
    blender = cls(cfg, params, tier, recompute_ratio=BLEND_RATIO)
    launches, out = {}, {"T": BLEND_T}

    def prefill_full():
        cache = (mla.new_latent_cache(cfg, 1, BLEND_T, device="cuda")
                 if mla_model
                 else llama.new_kv_cache(cfg, 1, BLEND_T, device="cuda"))
        logits, _ = model.forward(
            params, cfg, torch.as_tensor(full, device="cuda").long()[None],
            torch.zeros(1, dtype=torch.int32, device="cuda"), cache,
            last_logit_only=True)
        return logits[0, -1].float()

    def record(fn, force=None):
        """fn() with the MoE layers' expert choices recorded (MLA)."""
        if routing is None:
            return fn(), None
        with routing:
            routing.rows, routing.picks, routing.force = [0], [], force
            try:
                res = fn()
            finally:
                routing.rows, routing.force = None, None
            return res, torch.stack(routing.picks).sort(dim=-1).values

    reset_launch_counts()
    t0 = time.perf_counter()
    _, _, info = blender.blend(chunks)  # every chunk missing: stored
    torch.cuda.synchronize()
    out["store_and_blend_s"] = time.perf_counter() - t0
    launches[f"{name} blend store"] = read_launch_counts()
    logits, _, info2 = blender.blend(chunks)
    log(f"  first blend: {info['misses']} misses, {info['num_chunks']} "
        f"chunks stored and blended in {out['store_and_blend_s']:.2f} s; "
        f"second blend: {info2['misses']} misses, "
        f"{info2['recomputed_tokens']} of {info2['total_tokens']} tokens "
        f"recomputed")
    if not (info["misses"] == len(chunks) and info2["misses"] == 0):
        raise SystemExit(f"{name} blend: the second blend missed the tier")
    out["recomputed_tokens"] = info2["recomputed_tokens"]

    full_logits, ref_picks = record(prefill_full)
    blender.ratio = 1.0
    (exact, _, _), picks = record(lambda: blender.blend(chunks))
    flips = None
    if routing is not None:
        flips = [(int((picks != ref_picks).any(dim=-1).sum()),
                  picks.shape[0] * picks.shape[1])]
    ok = _logits_agree(f"{name} blend at ratio 1.0 vs full prefill",
                       [exact.float()], [full_logits], near_tie=mla_model,
                       flips=flips)
    if flips and flips[0][0]:
        (forced, _, _), _ = record(lambda: blender.blend(chunks),
                                   force=ref_picks)
        ok = ok and _logits_agree(
            f"{name} blend at ratio 1.0 routed as the full prefill",
            [forced.float()], [full_logits], near_tie=True)
    blender.ratio = 0.0
    naive, _, _ = blender.blend(chunks)
    blender.ratio = BLEND_RATIO
    out.update(exact_rel_l2=_rel(exact, full_logits),
               blend_rel_l2=_rel(logits, full_logits),
               naive_rel_l2=_rel(naive, full_logits), routing_flips=flips)
    log(f"  logits vs full prefill, rel_l2: ratio {BLEND_RATIO} "
        f"{out['blend_rel_l2']:.3e}, ratio 0 (naive reuse) "
        f"{out['naive_rel_l2']:.3e} (must be larger)")
    if not (ok and bool(torch.isfinite(logits).all())
            and out["blend_rel_l2"] < out["naive_rel_l2"]):
        raise SystemExit(f"{name} blend: the logits fail the gates")
    want_tok = int(logits.argmax())
    del exact, naive, full_logits

    out["engines"] = []
    for cls_, kw in engines:
        label = f"{cls_.__name__} {kw.get('kv_dtype', 'native')}"
        eng = cls_(cfg, params, max_batch=1, max_seq=BLEND_T + 64,
                   cache_engine=tier, device="cuda", **kw)
        reset_launch_counts()
        req = Request(np.empty(0, np.int32),
                      SamplingParams(max_new_tokens=BLEND_NEW),
                      context_chunks=chunks)
        eng.add_request(req)
        eng.run()
        torch.cuda.synchronize()
        launches[f"{name} blend {label}"] = read_launch_counts()
        log(f"  {label}: TTFT {req.ttft_s * 1e3:.2f} ms, "
            f"{req.blended_tokens_recomputed} tokens recomputed, first token "
            f"{req.output_tokens[0]} (blender {want_tok}), "
            f"{len(req.output_tokens)} tokens")
        if not (req.output_tokens[0] == want_tok
                and len(req.output_tokens) == BLEND_NEW):
            raise SystemExit(f"{label}: the blend request's first token is "
                             f"not the blender's")
        rec = {"engine": label, "ttft_ms": req.ttft_s * 1e3,
               "recomputed": req.blended_tokens_recomputed}
        if not out["engines"]:  # the first engine: TTFT and a profile

            def admit(eng=eng):
                r = Request(np.empty(0, np.int32),
                            SamplingParams(max_new_tokens=1),
                            context_chunks=chunks)
                eng.add_request(r)
                eng._admit_from_window()  # blend, inject, first token
                eng.run()
                return r

            times = [admit().ttft_s * 1e3 for _ in range(3)]
            rec["ttft_best_ms"] = min(times)
            rec["ttft_full_ms"] = wall_best(prefill_full, n=3)
            rec["profile"] = profile_window(f"{name} blend admission", admit)
            log(f"  TTFT blend {rec['ttft_best_ms']:.2f} ms (best of 3) vs "
                f"full prefill of {BLEND_T} tokens "
                f"{rec['ttft_full_ms']:.2f} ms: "
                f"{rec['ttft_full_ms'] / rec['ttft_best_ms']:.2f}x")
        out["engines"].append(rec)
        del eng
        torch.cuda.empty_cache()
    tier.close()
    return launches, out


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
    rows.update(coder_yardstick(gen, sm_clock_hz()))

    for case in latent_cases():
        args, kw = make_latent_inputs(case, gen)
        entry = KERNELS[case["kernel"]][0]
        decode = case["T"] == 1
        iters = 200 if decode else (5 if case["T"] > 4096 else 20)
        ms = cuda_ms(lambda: entry(*args, **kw), iters=iters)
        plain_ms = cuda_ms(lambda: latent_plain(case, args, kw), iters=3,
                           warmup=1)
        pre_ms, sdpa_ms, backends = latent_library(case, args, kw, iters)
        bound_ms, bound_by = latent_bound(case, args)
        row = {"shape": case["name"], "ms": ms, "plain_ms": plain_ms,
               "library_ms": (pre_ms or 0.0) + sdpa_ms,
               "library_prepare_ms": pre_ms, "library_sdpa_ms": sdpa_ms,
               "sdpa_backends": backends, "bound_ms": bound_ms,
               "bound_by": bound_by}
        prep = ("gather" if case["paged"] else "dequantize")
        lib = (f"{prep} {pre_ms:.4f} ms + " if pre_ms is not None else "") + (
            f"SDPA {sdpa_ms:.4f} ms (backends that take it: "
            f"{', '.join(backends)})")
        log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"library {lib}")
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
    launches = {}
    ablation_launches, ablation_rows, ablation_worst, ablation = (
        phase_ablation())
    launches.update(ablation_launches)
    max_abs.update(ablation_worst)

    cfg = llama.LlamaConfig.tinyllama_1_1b()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))

    # every path is driven with the counts at 0 and read just after
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
    remote_launches, remote = phase_remote(cfg, params, ttft["ttft_full_ms"])
    launches.update(remote_launches)
    del dense_logits
    torch.cuda.empty_cache()
    blend_launches, blend_out = phase_blend(
        cfg, params, False,
        engines=[(ServingEngine, {}), (ServingEngine, {"kv_dtype": "int8"}),
                 (PagedServingEngine, {"page_size": PAGE,
                                       "num_pages": NP_BLEND})])
    launches.update(blend_launches)
    del params
    torch.cuda.empty_cache()
    remote["codec_throughput"] = phase_codec_throughput()
    torch.cuda.empty_cache()
    launches.update(phase_paged_phi3())
    mistral_launches, mistral_profiles = phase_mistral()
    launches.update(mistral_launches)
    torch.cuda.empty_cache()
    mla_launches, mla_out = phase_mla(remote["store"]["wire_bytes"])
    launches.update(mla_launches)
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
        "remote store": ("range_encode", ("store",)),
        "remote reuse": [("range_decode", ("retrieve",)),
                         ("range_encode", ("store",)),
                         ("flash_attention", ("prefill",))],
        "remote paged": [("range_decode", ("retrieve",)),
                         ("paged_attention_dma", ("prefill",))],
        "mla bench": ("latent_flash_attention", ("prefill",)),
        "mla serving native": ("latent_flash_attention",
                               ("prefill", "decode")),
        "mla serving int8": ("quantized_latent_flash_attention",
                             ("prefill", "decode")),
        "mla paged bf16": ("paged_latent_attention_dma",
                           ("prefill", "decode")),
        "mla paged int8": ("quantized_paged_latent_attention_dma",
                           ("prefill", "decode")),
        "mla row 9": [("paged_latent_attention", ("prefill",)),
                      ("quantized_paged_latent_attention", ("prefill",))],
        "mla remote": [("range_encode", ("store",)),
                       ("range_decode", ("retrieve",)),
                       ("latent_flash_attention", ("prefill",))],
        "row 13 ablation": [("variant_attention",
                             ("full", "mxu_only", "no_mask", "pair",
                              "pair_no_mask")),
                            ("pipelined_attention", ("pipelined",))],
        "dense blend store": ("flash_attention", ("prefill",)),
        "dense blend ServingEngine native": ("flash_attention",
                                             ("decode",)),
        "dense blend ServingEngine int8": ("quantized_flash_attention",
                                           ("decode",)),
        "dense blend PagedServingEngine native": ("paged_attention_dma",
                                                  ("decode",)),
        "mla blend store": ("latent_flash_attention", ("prefill",)),
        "mla blend MLAServingEngine native": ("latent_flash_attention",
                                              ("decode",)),
        "mla blend MLAPagedServingEngine native": (
            "paged_latent_attention_dma", ("decode",)),
    }
    for phase, wanted in expected.items():
        for kernel, kinds in (wanted if isinstance(wanted, list)
                              else [wanted]):
            for kind in kinds:
                if launches[phase].get(kernel, {}).get(kind, 0) <= 0:
                    raise SystemExit(f"{kernel}: no {kind} launch in {phase}")

    rows = phase_yardstick()
    rows.update(ablation_rows)
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
              "ttft_streamed": stream_ttft, "remote": remote,
              "paged_decode_profiles": decode_profiles,
              "dense_decode_profiles": dense_decode_profiles,
              "mistral_profiles": mistral_profiles, "mla": mla_out,
              "ablation": ablation, "blend": blend_out, "card": card}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
