#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lmcache_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the package from its sources (one ``nvcc``
   per source, all at once) and print the build time and nvcc's report
   (registers and spills of every kernel), and the number of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in the libraries of the
   Hopper bodies, kernel rows 1-10 and 13 (``cuobjdump -sass``), each of
   which must be above 0, and ptxas's notes on wgmma; then, per
   instantiation, the registers, spills, ``HGMMA`` and ``UTMALDG`` of rows
   5 and 7's int8 paged body and split (the body's four and the split's
   registers must be above 0), of the softcap variants of rows 4-7's body
   and split, and of row 13's 14 variant instantiations (each with
   registers, wgmma and TMA);
2. hold each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the paths below give it: ``flash_attention`` (plain
   and with each option: sliding and chunked window, softcap, sinks,
   ``kv_slot``, at the public shapes of Mistral, Phi-3, Gemma-2, GPT-OSS and
   Llama-4; its decode runs the key-split decode), the split decode's
   ``combine_partials`` alone (on row 1's and on the paged split's
   partials), ``flash_attention_dma``, ``quantized_flash_attention`` (plain
   and with the same options), the four paged-attention kernels (bf16 and
   int8 arenas; their decodes run the paged key split; with softcap, sinks
   and chunked windows at Gemma-2's, GPT-OSS's and Llama-4's shapes, rows
   4 and 5 with each at D 96 and D 256, and chunks of 24 keys over pages of
   16: ``paged_option_cases``; the softcap at a cap of 3, which must move
   the plain output by ten times the tolerance, and at Gemma-2's 50 in its
   own prefill segment), the range coders
   at the remote paths' launches (tolerance 0: row 12 and its copy pass,
   row 11's symbols and its fused entry's blob) and the six MLA
   latent-attention entry points (dense, paged one page per step, paged
   streamed; bf16 and int8 latents) at DeepSeek-V2-Lite's shapes and at
   128 heads, V2/V3's, and the latent split decode's combine alone; then
   rows 1, 3, 4-7 and 8-10 at the shape of a ``spec_lookahead`` 4
   verification, T 5 a row over four rows of different kv_len with random
   K/V past each (``verify_cases``);
3. the dense main path at full width, tinyllama-1.1B with random weights
   from a seeded generator: full prefill of CTX + SUFFIX = 16384 tokens,
   store of the CTX prefix into the "cuda" cache tier, retrieve (15872
   hits), inject, suffix prefill; the reuse logits must agree with the full
   prefill's; TTFT full and reuse (best of 3 after a warm-up); one
   ``torch.profiler`` window over each (device idle share, the kernels
   that take the time), the full prefill's device time also by events
   around it queued behind a spin of the card;
4. dense serving: a ``ServingEngine`` answers four waves of greedy prompts;
   a repeated wave must hit the cache and give the same tokens, and a
   suffix prefilled over an injected prefix must agree with an engine
   that has no cache tier (``phase_serving``);
5. paged serving, path A: a ``PagedServingEngine`` over a bf16 and then an
   int8 page arena, tinyllama-1.1B (head dim 64: the streaming kernels),
   four waves: fresh prompts against the dense engine's logits, the same
   prompts served from resident pages, a fresh engine served by retrieve +
   page injection, and, with the prompts grown to 3 tokens short of 33
   pages, an arena so small that decode growth preempts a request, which
   resumes and finishes; one ``torch.profiler`` window over a batched
   decode step (``phase_paged_tinyllama``);
6. paged serving, path B: Phi-3-mini-4k at full width and depth (head dim
   96, sliding window 2047: the one-page-per-step kernels), two prompts of
   about 3000 tokens over a bf16 and then an int8 arena; the logits of the
   last prompt token are held against ``forward_paged*`` run with the plain
   attention on the same arena; one ``torch.profiler`` window over a
   prefill step of two fresh prompts and one over a decode step, per arena
   (``phase_paged_phi3``, ``paged_full_depth``);
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
   (quantize, CDF, one range-encoder launch for both halves, row 12, and
   its copy pass); every container must equal the host C++ coder's, the
   card's quantizer and CDF the CPU's (the encode's parts:
   ``python -m lmcache_tpu_torch.tools.store_split``), and the containers
   fetched through the native transport must equal those fetched through
   the Python client. Then, per transport (the Python socket client, then
   the native one), a fresh pipelined instance B under a
   ``ServingEngine`` serves the 16384-token prompt: groups of 16
   still-coded chunks uploaded from pinned memory, one launch a group of
   row 11's fused entry (decode and dequantization into the blob), inject,
   suffix prefill; every group's symbols (decoded again on the card) must
   equal the host C++ decode and its blob those symbols dequantized, the
   slot the KV of ``retrieve()`` with the host decoder, and the KV
   injected through the two transports must be bit-equal. Per transport:
   TTFT remote (best of 3 and median, each request a new suffix) beside
   phase 3's TTFT full, a ``torch.profiler`` window of one request (its
   pageable and pinned host-to-device copies; the group uploads must be
   pinned), the overlap of the groups' device work with the host's fetch
   and parse (``grouped_stream_overlap``, which decides on a second
   stream) and the stage split of bench.py:470-526; then a
   ``PagedServingEngine`` wave over the same server whose pages must equal
   the dense slot (``phase_remote``); 9b: codec throughput at bench.py's
   reference geometry (``phase_codec_throughput``);
10. MLA, DeepSeek-V2-Lite at full width and depth (27 layers, 16 heads,
   latent 576, 64 routed + 2 shared experts; random bf16 weights from a
   seeded generator, 31.4 GB; ``phase_mla``): 10a the bench shape through
   ``mla.forward`` (full prefill, store of the CTX prefix's latent blobs
   into the "cuda" tier, retrieve, inject, suffix prefill; reuse logits
   held to the full prefill's; TTFT full and reuse, a profiler window
   each); 10b phase 4's four waves on ``MLAServingEngine`` over the native
   and the int8 latent pool, and a profiled decode step; 10c phase 5's
   waves on ``MLAPagedServingEngine`` (page 64), bf16 then int8 arena, the
   injected pages equal to the dense pool's slots, a profiled prefill step
   of fresh prompts and a profiled decode step; 10d kernel row 9, which
   no serving path calls: the last prefill segment again with the paged
   forward's attention bound to it, logits held to row 10's; 10e the latent
   prefix through the cache server with CacheGen (N = 1 containers equal to
   the host C++ coder's, a fresh pipelined engine's fused decodes checked
   as phase 9's; logits and wire bytes reported). Where phase 10
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
   function, against row 1; each timed (by events back to back, and queued
   behind a spin) beside its bound, its plain version, row 1 and SDPA, and
   the Hopper body's time split three ways: the softmax's share
   (``full`` - ``mxu_only``), the mask's (``full`` - ``no_mask`` scaled to
   ``full``'s work) and what the overlap of ``pipelined`` buys at equal
   tiles (``pair`` - ``pipelined``), beside ``full`` - ``pipelined``, which
   at D 128 also holds 128-key tiles against 64 (``phase_ablation``; run
   right after phase 2);
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
13. the ``LlamaConfig`` families that the forwards refused before (Qwen3,
   Qwen3-MoE, Mixtral, Gemma-2/3, GLM-4-0414, OLMo-2, GPT-OSS, Llama-4):
   13a each of the ten presets at full width and 2 layers (a global layer
   among them) with random bf16 weights, a 2048-token prompt and 3 decode
   steps over the dense native and int8 pools and the bf16 and int8
   arenas, the prompt's last-token logits and the last step's held against
   the same forward with the plain attention on a copy of the pool (an MoE
   preset's plain forward routed as its kernel forward;
   ``phase_presets``); 13b Qwen3-30B-A3B at full width and depth (61 GB of
   random weights, after V2-Lite's are freed; ``phase_qwen3_moe``): the
   bench shape (TTFT full and reuse, reuse logits held to the full
   prefill's under phase 10's routing rule, the MoE MLP's device time and
   padded rows, a profiler window each), phase 4's waves on
   ``ServingEngine`` and phase 5's on ``PagedServingEngine`` per dtype
   with the experts counted (``Routing``) and profiled decode steps; 13c
   Gemma-2-9B at full width and depth on ``PagedServingEngine`` (window
   4096 on alternate layers, softcap 50), two prompts of about 6000
   tokens over a bf16 and an int8 arena, held as phase 6 holds Phi-3
   (``phase_gemma2``);
14. the decode options of the four engines (``phase_decode_options``;
   14a after 12a on tinyllama-1.1B at full depth, the dense native and
   int8 and the paged bf16 and int8 engines; 14b at the end of phase 10 on
   DeepSeek-V2-Lite's weights at full width cut to 3 layers, the MLA dense
   and paged engines): four requests of 211-320 tokens, 17 new tokens
   each. Sequential greedy with ``logprobs=5`` gives the golden tokens,
   its logprobs held to the fp32 plain witness (the forward with the
   plain attention and an fp32 LM head) within ``TOP1_MARGIN`` of the
   witness logits' rms; ``decode_block`` 4 must give the tokens of
   ``decode_block`` 1 bit for bit with at most one host sync a block
   (decode tok/s, host and device ms a step for each); ``spec_lookahead``
   4 with the n-gram proposer and with an oracle that proposes the golden
   continuation (proposed, accepted, verification forwards) must give the
   golden tokens, or differ first where the witness puts the two tokens
   within ``TIE_STEPS`` bf16 steps;
15. the codec quality gate of ``tools/eval_quality.py`` on the in-repo
   trained checkpoints, through ``lmcache_tpu_torch.tools.eval_quality`` in
   bf16 at ctx 8192 + cont 64 (bench.py:772's geometry; after phase 16):
   the dense checkpoint (D 64, 4 query heads over 2 KV heads: row 1) and
   the MLA one (latent 128 + 32, 4 heads: row 8), each through a CacheGen
   round trip of its context's KV (rows 12 and 11), must pass the JAX
   tool's gates (KL <= 0.05, confident top-1 >= 0.99, perplexity delta <
   0.1); the dense sweep (default bins, then 16, 8, 4 and 2) must move the
   KL past the default row's (at 2 bins the dequantization is 0 / 0, a NaN
   KL, in both packages); rows 12 and 11 on the trained dense blob must
   give the host C++ coder's container and blob (``phase_quality``);
16. the disk and hybrid tiers under the dense ``ServingEngine`` on
   tinyllama-1.1B at the bench shape (after phase 14a): engine A stores the
   CTX prefix on a disk tier in a fresh temporary directory, engine B over
   the same directory (its key index replayed) serves the prompt with the
   device tier's 15872 hits, tokens, first-token logits and injected KV bit
   for bit; TTFT reuse from disk beside the device tier's and the disk's
   get time a chunk; then the hybrid tier ("cuda" in front of the cache
   server, CacheGen): one instance writes through, a fresh one prefetches
   at start (row 11 a chunk) and a fresh one with prefetch 0 fills on its
   first request, each injecting the remote path's decode of the same
   containers bit for bit, the local tier holding every chunk after; the
   TTFT of each (``phase_tiers``);
17. HuggingFace checkpoints in (after phase 16, ``phase_checkpoints``):
   phase 3's tinyllama-1.1B weights written by the script's own writer as a
   HF checkpoint directory (``config.json``, two safetensors shards and
   their index, HF names, ``[out, in]`` weights) and read back: ``from_hf``
   must equal ``tinyllama_1_1b()`` field for field, ``load_hf`` every
   parameter bit for bit, and a prefill of phase 3's tokens from the loaded
   weights phase 3's first-token logits bit for bit (then a decode step
   the in-memory weights'); the same for DeepSeek-V2-Lite at 3 layers
   (dense, MoE, MoE; ``kv_b_proj`` split) with a 2048-token prefill and a
   decode step; the load time and the host's resident-set growth of each;
18. the OpenAI-compatible HTTP front (``phase_http``): the port's
   ``APIServer`` over a ``ServingEngine`` with the loaded tinyllama and a
   "cuda" tier on 127.0.0.1 (``http.client``): ``/health``,
   ``/v1/models``, a 2048-token completion, the same prompt streamed, 8
   concurrent completions, ``n`` 2 with a seed, a stop string, logprobs 2
   and a three-turn chat; greedy and seeded tokens bit-equal to the engine
   driven directly in the same cache state, the streamed text the
   non-streamed text, the logprobs within phase 14's rule against the fp32
   witness, the chat's cached tokens climbing (the tier flushed between
   turns); ``usage.ttft_ms`` against the client's time to the first byte;
19. the engine hook API (``phase_hooks``), an outside loop at tinyllama's
   full depth: a 4096-token prefill stored through ``lmcache_store_kv``,
   then for it plus 512 tokens ``lmcache_retrieve_kv``, ``blob_into_cache``
   and a prefill of ``build_partial_prefill_input``, held to a full prefill
   by phase 3's gate; the pieces of ``lmcache_retrieve_kv_stream``
   bit-equal to the retrieved blob, and a stream closed after its first
   piece leaving the engine usable;
20. the examples of ``lmcache_tpu_torch/examples`` through their ``main()``
   (``phase_examples``): tinyllama-1.1B (DeepSeek-V2-Lite at 3 layers for
   the MLA one), the three that need a cache server on the script's own;
   each claim gated: reuse with the same tokens (offline, across two
   instances, prefill/decode separated, MLA), the generated tokens hit
   (save_decode_cache), cached tokens climbing over HTTP rounds, the YAML
   gallery round-tripped bit for bit (CacheGen within ``PSNR_DB``),
   CacheBlend closer to a full prefill than naive reuse, speculation with
   greedy tokens in fewer engine steps;
21. the quality checkpoints' trainer (``phase_training``, fp32, TF32 off):
   one step on the card against the CPU from each committed checkpoint
   (loss, gradients, the update), 200 steps of the dense model from seed 0
   (the loss must fall), 10 steps of the --init finetune at T 8256 under
   remat (copy accuracy at least 0.99; the peak memory with and without
   remat), the self-check bands of both checkpoints; no hand kernel may
   launch;
22. parallelism on one card (``phase_parallel_kernels``,
   ``phase_parallel_engines``; after phase 19): 22a each rank's launches of
   rows 1 and 3-10 at full width on its contiguous head slices (tinyllama
   at "model" 2 and 4, Llama-3-8B's attention at 8, DeepSeek-V2-Lite's
   latent attention at 2, 4 and 16; a 512-token segment over 16k keys and
   a decode), put back together along the head axis: rows 1 and 3-7 must
   give the unsharded launch's bits, rows 8-10 their tolerance against the
   plain version (each shard's route printed), every launch held against
   its plain version; 22b the distributed path on a one-rank NCCL group:
   the dense engine (with a "cuda" tier, each prompt twice), the paged
   engine, a CacheBlend request and both MLA engines (V2-Lite at 3 layers)
   with ``mesh=`` must give the tokens of the same engine without a mesh
   bit for bit, and ``forward_ring`` at T 4096 must hold ``forward``'s
   logits by phase 3's rule; NCCL across several ranks is not run here
   (one GPU; ``lmcache_tpu_torch/tools/mesh_check.py`` runs it on four);
7. the launch counts of phases 3 to 22, read per phase with every count
   set to 0 just before it (prefill and decode, each > 0 where the phase
   runs them; "+window", "+softcap" and "+sinks" mark launches under those
   options; the coders count "store" and "retrieve" launches);
8. the yardstick: each kernel's time at phase 2's shapes beside its bound,
   its plain version and a PyTorch library time (SDPA; for a paged arena
   the gather of the live pages into dense K/V, then SDPA; for int8 K/V the
   dequantization to bf16, then SDPA; none where softcap or sinks leave no
   single call; for the latent kernels SDPA with the latents expanded over
   the heads as K and their first rank columns as V, the SDPA backends that
   take those shapes named); at decode also the device time of the dense
   and latent kernels, the paged kernels and the combine on the paged
   split's partials alone (``torch.profiler``); each paged case (rows 4-7,
   options included) also with the L2 cache flushed before each launch,
   and by events around calls queued behind a spin of the card
   (``queued_ms``, warm and L2-cold): a time that the host cannot lengthen
   and that does not rest on the profiler's records; every case of rows 1,
   3 and 8-10 and both combines also queued (warm), and the verification
   shapes of phase 2 all of these ways. No PyTorch call computes
   a range coder: the coders' rows (row 12 and its copy pass at tinyllama's
   store, phase 9b's geometry and V2-Lite's latent store; row 11's two
   entries at a retrieve group of each) carry the host C++ coder's time at
   the same shape instead; none computes the split decodes' combines
   either.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without printing a result
when CUDA is unavailable or the package is missing.
"""

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,
                               LMCacheEngineMetadata)
from lmcache_tpu_torch import blend, blend_mla, kv, metrics, ops
from lmcache_tpu_torch.chunks import prefix_chunk_hashes
from lmcache_tpu_torch.codec import CacheGenConfig, range_coder
from lmcache_tpu_torch.models import experts, llama, mla, paged
from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops import attention as attn
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
from lmcache_tpu_torch.serving import engine as engine_mod
from lmcache_tpu_torch.storage.connector.lm_connector import \
    LMCServerConnector
from lmcache_tpu_torch.storage.serde import cachegen_serde as cgs
from lmcache_tpu_torch.tools import bench_prefill_mfu as bench_mfu
from lmcache_tpu_torch.tools import eval_quality, quality_common
from lmcache_tpu_torch.tools import train_quality_model as train_tool
from lmcache_tpu_torch.utils import resolve_device

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
# two engines' first tokens that differ count as one top-1 (phase 5) only
# where the fp32 witness puts their logits at most one bf16 step apart at
# their magnitude: the engines round their logits to bf16 (to nearest,
# ties to even), which can map two values up to a step apart onto one
# value, and argmax then takes the lower index; two logits further apart
# keep their order through the rounding
TIE_STEPS = 1.0

CTX, SUFFIX = 15872, 512
PAGE = 64  # page size of both paged paths

# the port's kernels: name -> (wrapper, source, TPU kernel it replaces)
KERNELS = {
    "flash_attention": (
        ops.flash_attention, "lmcache_tpu_torch/ops/csrc/flash_attention.cu",
        "lmcache_tpu/ops/attention.py:110"),
    # the second kernel of the key-split decodes of rows 1 and 3-7
    "combine_partials": (
        attn.combine_partials,
        "lmcache_tpu_torch/ops/csrc/flash_attention.cu",
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
    # row 12's copy pass: the coded bytes of the staging rows to the payload
    "range_encode_compact": (
        re_.compact, "lmcache_tpu_torch/ops/csrc/range_encode.cu",
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
    # the second kernel of row 10's key-split decode
    "latent_combine_partials": (
        pla.combine_partials,
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


def kernel_ms(fn, iters):
    """Mean device time in ms of the kernels ``fn`` launches, over ``iters``
    calls under ``torch.profiler`` after a warm-up: without the gaps in
    which the card waits for the host, which CUDA events around small
    launches count too. None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("lmcache_tpu_torch::"))
    return total / 1e3 / iters if total > 0 else None


def wall_best(fn, n=3, warm=True):
    """Best host time in ms of ``fn`` (ending in a synchronize) over ``n``
    runs after one warm-up run (``warm=False``: the caller's own runs of
    ``fn`` were the warm-up)."""
    if warm:
        fn()
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


# rows 5 and 7's instantiations (mangled): the Hopper body and the split
# decode over an int8 (``a``, signed char) paged (``Lb1E``) arena
INT8_PAGED = {"body": re.compile(r"flash_sm90_fwdILi(\d+)ELi\d+ELb0EaLb1EE"),
              "split": re.compile(r"decode_split_fwdILi(\d+)ELb0EaLb1EE")}


def sass_counts(libs):
    """The wgmma (``HGMMA``) and TMA load (``UTMALDG``) instructions in the
    built libraries of rows 1-10 and 13, the Hopper bodies, and per
    function; exits where a library's count is 0. Returns {library:
    {function: {op: count}}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    per_function = {}
    for name in ("flash_attention", "flash_stream_attention",
                 "quantized_flash_attention", "paged_attention",
                 "paged_stream_attention", "latent_attention",
                 "paged_latent_attention", "prefill_variants"):
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("HGMMA", "UTMALDG")}
        log(f"  {name}: {counts['HGMMA']} HGMMA and {counts['UTMALDG']} "
            f"UTMALDG instructions (cuobjdump -sass)")
        if not all(counts.values()):
            raise SystemExit(f"{name} was built without wgmma or TMA")
        funcs = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            fname, _, body = part.partition("\n")
            funcs[fname.strip()] = {op: len(re.findall(rf"\b{op}\b", body))
                                    for op in ("HGMMA", "UTMALDG")}
        per_function[name] = funcs
    return per_function


def ptxas_report(text):
    """{function: {"registers": n, "spill_bytes": m, "wgmma_serialized": 0
    or 1}} from nvcc's ``-Xptxas -v`` report of one library (functions by
    their mangled names); ``wgmma_serialized`` where ptxas notes that it
    serialized the function's wgmma (C7512)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"wgmma\.mma_async instructions are serialized .*"
                      r"function '([\w$]+)'", line)
        if m:
            out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": 0})
            out[m.group(1)]["wgmma_serialized"] = 1
            continue
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0,
                                              "spill_bytes": 0,
                                              "wgmma_serialized": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def int8_paged_report(sass):
    """Registers, spills, HGMMA and UTMALDG of each int8 paged instantiation
    of rows 5 and 7 (``paged_attention.cu``, ``paged_stream_attention.cu``);
    exits where one was not built or reports no registers, or where the
    body lacks wgmma or TMA. Returns the rows it logged."""
    rows = []
    for lib in ("paged_attention", "paged_stream_attention"):
        # nvcc's report exists where this process built the library
        built = lib in _build.build_logs
        regs = ptxas_report(_build.build_logs.get(lib, ""))
        for kind, pattern in INT8_PAGED.items():
            found = {f: c for f, c in sass[lib].items() if pattern.search(f)}
            if not found:
                raise SystemExit(f"{lib}: no int8 paged {kind} was built")
            for fname, counts in sorted(found.items()):
                D = int(pattern.search(fname).group(1))
                report = regs.get(fname, {"registers": 0, "spill_bytes": 0})
                row = dict(library=lib, kind=kind, D=D, **report, **counts)
                rows.append(row)
                log(f"  {lib} int8 paged {kind} D {D}: "
                    f"{report['registers']} registers, "
                    f"{report['spill_bytes']} spill bytes, "
                    f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
                if ((built and report["registers"] <= 0)
                        or (kind == "body"
                            and not (counts["HGMMA"] and counts["UTMALDG"]))):
                    raise SystemExit(f"{lib}: the int8 paged {kind} at D {D} "
                                     f"has no registers, wgmma or TMA")
    return rows


# row 13's instantiations (mangled): variant_sm90_fwd<D, mode, schedule>
VARIANT_BODY = re.compile(r"variant_sm90_fwdILi(\d+)ELi(\d)ELi(\d)EE")
VARIANT_MODES = ("full", "no_mask", "mxu_only")
VARIANT_SCHEDULES = ("step", "pair", "pipelined")


def variant_report(sass):
    """Registers, spills, HGMMA and UTMALDG of each instantiation of row
    13's template (``prefill_variants.cu``: D 64 and 128, three modes by
    two schedules and ``pipelined``); exits where one of the 14 was not
    built, reports no registers, or lacks wgmma or TMA. Returns the rows
    it logged."""
    lib = "prefill_variants"
    built = lib in _build.build_logs
    regs = ptxas_report(_build.build_logs.get(lib, ""))
    found = {f: c for f, c in sass[lib].items() if VARIANT_BODY.search(f)}
    if len(found) != 14:
        raise SystemExit(f"{lib}: {len(found)} variant instantiations built,"
                         f" not 14")
    rows = []
    for fname, counts in sorted(found.items()):
        D, mode, sched = (int(g) for g in VARIANT_BODY.search(fname).groups())
        report = regs.get(fname, {"registers": 0, "spill_bytes": 0,
                                  "wgmma_serialized": 0})
        row = dict(library=lib, D=D, mode=VARIANT_MODES[mode],
                   schedule=VARIANT_SCHEDULES[sched], **report, **counts)
        rows.append(row)
        log(f"  {lib} D {D} {row['mode']} {row['schedule']}: "
            f"{report['registers']} registers, {report['spill_bytes']} "
            f"spill bytes, {counts['HGMMA']} HGMMA, {counts['UTMALDG']} "
            f"UTMALDG"
            + (", wgmma serialized (ptxas)" if report["wgmma_serialized"]
               else ""))
        if ((built and report["registers"] <= 0)
                or not (counts["HGMMA"] and counts["UTMALDG"])):
            raise SystemExit(f"{lib}: D {D} {row['mode']} {row['schedule']} "
                             f"has no registers, wgmma or TMA")
    return rows


# the softcap instantiations of rows 4-7 (mangled): the Hopper body and the
# split decode over a paged (``Lb1E``) bf16 or int8 (``a``) arena
PAGED_SOFTCAP = {
    "body": re.compile(r"flash_sm90_fwdILi(\d+)ELi\d+ELb1E"
                       r"(a|13__nv_bfloat16)Lb1EE"),
    "split": re.compile(r"decode_split_fwdILi(\d+)ELb1E"
                        r"(a|13__nv_bfloat16)Lb1EE")}


def paged_softcap_report(sass):
    """Registers, spills, HGMMA and UTMALDG of each softcap instantiation
    of rows 4-7's body and split (bf16 and int8 arenas); exits where one
    was not built. Returns the rows it logged."""
    rows = []
    for lib in ("paged_attention", "paged_stream_attention"):
        regs = ptxas_report(_build.build_logs.get(lib, ""))
        for kind, pattern in PAGED_SOFTCAP.items():
            found = {f: c for f, c in sass[lib].items() if pattern.search(f)}
            if not found:
                raise SystemExit(f"{lib}: no paged softcap {kind} was built")
            for fname, counts in sorted(found.items()):
                m = pattern.search(fname)
                D, arena = int(m.group(1)), ("int8" if m.group(2) == "a"
                                             else "bf16")
                report = regs.get(fname, {"registers": 0, "spill_bytes": 0})
                rows.append(dict(library=lib, kind=kind, D=D, arena=arena,
                                 **report, **counts))
                log(f"  {lib} softcap {kind} D {D} {arena}: "
                    f"{report['registers']} registers, "
                    f"{report['spill_bytes']} spill bytes, "
                    f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
    return rows


# ---------------------------------------------------------------- phase 2 ---

SERVE_S = 2048 + 64 + 1  # phase 4's pool: max_seq + one parking position
# phase 15: bench.py:772's geometry of the codec quality gate; its forwards
# run over a pool of QUALITY_S tokens
QUALITY_CTX, QUALITY_CONT = 8192, 64
QUALITY_S = QUALITY_CTX + QUALITY_CONT


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


def quality_attention_cases():
    """:func:`attention_cases`' tuples at phase 15's trained dense checkpoint
    (H 4 over H_kv 2, D 64): the context's prefill and the continuation's
    over it."""
    return [
        ("quality-8l context prefill", 1, QUALITY_CTX, 4, 2, 64, QUALITY_S,
         [0], [QUALITY_CTX]),
        ("quality-8l continuation", 1, QUALITY_CONT, 4, 2, 64, QUALITY_S,
         [QUALITY_CTX], [QUALITY_S]),
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


def combine_cases():
    """The decode cases of :func:`attention_cases`: the launches of at most
    ``DECODE_ROWS`` rows, whose partials the combine kernel merges."""
    return [case for case in attention_cases()
            if case[2] * case[3] // case[4] <= attn.DECODE_ROWS]


def make_combine_inputs(case, gen):
    """The partials row 1's split decode gives the combine at ``case``
    (from the plain split version, on the card)."""
    q, k, v, qo, kl = make_attention_inputs(case, gen)
    part_o, part_ml = attn.split_partials_reference(
        q, k.transpose(1, 2), v.transpose(1, 2), qo, kl)
    return part_o, part_ml, case[2], case[3] // case[4]


def combine_bound(part_o, part_ml, T, G):
    """Least time (ms) of the combine: (m, l) of every partial and O of
    each live one (l > 0) read once, bf16 out written once."""
    live = int((part_ml[..., 1] > 0).sum())
    B, Hkv, _, _, D = part_o.shape
    nbytes = part_ml.numel() * 4 + live * D * 4 + B * T * Hkv * G * D * 2
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


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

    def hold_attention(case, gen):
        q, k, v, qo, kl = make_attention_inputs(case, gen)
        out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
        ref = plain_attention(q, k, v, qo, kl)
        torch.cuda.synchronize()
        worst["flash_attention"] = max(
            worst["flash_attention"],
            hold_against_plain("flash_attention", case[0], out, ref))

    def hold_latent(case, gen):
        args, kw = make_latent_inputs(case, gen)
        out = KERNELS[case["kernel"]][0](*args, **kw)
        ref = latent_plain(case, args, kw)
        torch.cuda.synchronize()
        worst[case["kernel"]] = max(
            worst[case["kernel"]],
            hold_against_plain(case["kernel"], case["name"], out, ref))

    for case in attention_cases():
        hold_attention(case, gen)

    def hold_combine(name, part_o, part_ml, T, G):
        out = attn.combine_partials(part_o, part_ml, T, G)
        ref = attn.combine_partials_reference(part_o, part_ml, T, G)
        torch.cuda.synchronize()
        worst["combine_partials"] = max(
            worst["combine_partials"],
            hold_against_plain("combine_partials", name, out, ref))

    for case in combine_cases():
        hold_combine(case[0], *make_combine_inputs(case, gen))
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
    # after the paged kernels' inputs, so that every earlier case draws the
    # same numbers from the generator as before the paged split existed
    for case in paged_combine_cases():
        hold_combine(case["name"], *make_paged_combine_inputs(case, gen))
    skip_former_coder_draws(gen)
    for i, case in enumerate(coder_cases()):
        for kernel, err in hold_coder_against_plain(case, 100 + i).items():
            worst[kernel] = max(worst[kernel], err)
    for case in latent_cases():
        hold_latent(case, gen)
    for case in latent_combine_cases():
        part_o, part_ml, T, H = make_latent_combine_inputs(case, gen)
        out = pla.combine_partials(part_o, part_ml, T, H)
        ref = pla.combine_partials_reference(part_o, part_ml, T, H)
        torch.cuda.synchronize()
        worst["latent_combine_partials"] = max(
            worst["latent_combine_partials"],
            hold_against_plain("latent_combine_partials", case["name"], out,
                               ref))
        del part_o, part_ml, out, ref
    opt_gen = torch.Generator(device="cuda").manual_seed(13)
    for case in paged_option_cases():
        args, kw = make_paged_inputs(case, opt_gen)
        out = KERNELS[case["kernel"]][0](*args, **kw)
        ref = paged_plain(case)(*args, **kw)
        torch.cuda.synchronize()
        if case["softcap"] and not case["own_cap"]:
            cap_moves(case, args, kw, ref)
        worst[case["kernel"]] = max(
            worst[case["kernel"]],
            hold_against_plain(case["kernel"], case["name"], out, ref))
        del args, out, ref
    ver_gen = torch.Generator(device="cuda").manual_seed(14)
    for family, case in verify_cases():
        kernel, call, plain, _, _ = verify_call(family, case, ver_gen)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        worst[kernel] = max(worst[kernel], hold_against_plain(
            kernel, case["name"], out, ref))
        del call, plain, out, ref
    # phase 15's shapes of rows 1 and 8, from a generator of their own so
    # that every earlier case draws the same numbers as before
    quality_gen = torch.Generator(device="cuda").manual_seed(16)
    for case in quality_attention_cases():
        hold_attention(case, quality_gen)
    for case in quality_latent_cases():
        hold_latent(case, quality_gen)
    return worst


def cap_moves(case, args, kw, ref):
    """Exits unless the cap moves the plain version's output at ``case`` by
    at least CAP_MOVES (rel_l2): a kernel that ignored the cap would then
    fail its own tolerance there."""
    uncapped = paged_plain(case)(*args, **dict(kw, logit_softcap=None))
    moved = ((ref.float() - uncapped.float()).norm()
             / ref.float().norm()).item()
    ok = moved >= CAP_MOVES
    log(f"    the cap moves the plain output by rel_l2 {moved:.3e} (at "
        f"least {CAP_MOVES:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{case['kernel']} | {case['name']}: the cap does "
                         f"not move the plain output past the tolerance")


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


# the options of a paged case, off: no window kind but sliding, no softcap,
# no sinks, the default score scale, pages of PAGE rows
PAGED_OFF = dict(kind="sliding", softcap=None, sinks=False, sm_scale=None,
                 page=PAGE)


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
            cases.append(dict({**PAGED_OFF, **shape}, kernel=kernel,
                              quant=quant,
                              kv_len=[o + shape["T"] for o in shape["q_off"]],
                              table=shape.get("table", "fragmented"),
                              idle=shape.get("idle", [])))
    return cases


# Gemma-2's, GPT-OSS's and Llama-4's tables: max_seq 8192 (Gemma-2), and the
# 16384 positions a prompt of phases 2 and 8 reaches (GPT-OSS, Llama-4)
NP_GEMMA2 = -(-(8192 + 1) // PAGE)
NP_16K = -(-(16384 + 1) // PAGE)
# The scores of these random inputs are about N(0, 1) at the default scale
# (bf16 arena), where cap * tanh(s / cap) differs from s by about
# s^3 / (3 cap^2): Gemma-2's cap of 50 moves a bf16 case's output by well
# under REL_L2_KERNEL, so a kernel that ignored it would pass. A cap of 3
# moves them by about a third (phase 2 logs it). Each softcap case but
# Gemma-2's own shape case holds its plain version with and without the cap
# at least CAP_MOVES apart (rel_l2), so that it fails a kernel that drops
# the cap.
CAP_SMALL = 3.0
CAP_MOVES = 10 * REL_L2_KERNEL


def paged_option_cases():
    """Rows 4-7 with the options of the presets that have them, at their
    public shapes, over bf16 and int8 arenas, each a prefill segment (the
    Hopper body) and a decode (the paged split and the combine): Gemma-2
    (D 256, softcap 50, window 4096), GPT-OSS (D 64, H 64, H_kv 8, sinks,
    window 128), Llama-4 (D 128, H 40, H_kv 8, chunks of 8192) on the
    streaming rows 6 and 7, as the paged forward gives them; rows 4 and 5
    with each option at D 96 (Phi-3's geometry) and D 256 (Gemma-2's); and
    chunks of 24 keys over pages of 16 (a chunk boundary inside a page).
    Drawn from their own generator after every other case of phases 2 and
    8. Softcap at ``CAP_SMALL`` except in Gemma-2's own prefill segment
    (``own_cap``), which keeps its cap of 50."""
    off = dict(PAGED_OFF, window=None, idle=[], table="fragmented",
               own_cap=False)
    gemma2 = dict(H=16, Hkv=8, D=256, NP=NP_GEMMA2, sm_scale=256.0**-0.5)
    gpt_oss = dict(H=64, Hkv=8, D=64, NP=NP_16K, sinks=True)
    llama4 = dict(H=40, Hkv=8, D=128, NP=NP_16K, window=8192,
                  kind="chunked")
    phi3 = dict(H=32, Hkv=32, D=96, NP=NP_PHI3)
    cap = f"softcap {CAP_SMALL:g}"
    shapes = [
        ("stream", "gemma-2 prefill segment past the window (softcap 50, "
         "window 4096)", dict(gemma2, T=512, q_off=[5120], window=4096,
                              softcap=50.0, own_cap=True)),
        ("stream", f"gemma-2 prefill segment past the window ({cap}, "
         "window 4096)", dict(gemma2, T=512, q_off=[5120], window=4096,
                              softcap=CAP_SMALL)),
        ("stream", f"gemma-2 decode, local layer ({cap}, window 4096)",
         dict(gemma2, T=1, q_off=[6005, 5995], window=4096,
              softcap=CAP_SMALL)),
        ("stream", f"gemma-2 decode, global layer ({cap})",
         dict(gemma2, T=1, q_off=[8000, 3000], softcap=CAP_SMALL)),
        ("stream", "gpt-oss prefill segment (sinks, window 128)",
         dict(gpt_oss, T=512, q_off=[2000], window=128)),
        ("stream", "gpt-oss decode, global layer (sinks)",
         dict(gpt_oss, T=1, q_off=[4000, 17])),
        ("stream", "llama-4 prefill, a block across the chunk boundary",
         dict(llama4, T=512, q_off=[8001])),
        ("stream", "llama-4 decode (chunk 8192)",
         dict(llama4, T=1, q_off=[8191, 8192])),
        ("stream", "chunks of 24 keys over pages of 16 (D 128)",
         dict(H=40, Hkv=8, D=128, NP=64, T=100, q_off=[700], window=24,
              kind="chunked", page=16)),
        ("grid", f"D 96 prefill segment ({cap}, window 2047)",
         dict(phi3, T=512, q_off=[2560], window=2047, softcap=CAP_SMALL)),
        ("grid", "D 96 decode (sinks, window 2047)",
         dict(phi3, T=1, q_off=[3010, 2990], window=2047, sinks=True)),
        ("grid", "D 96 prefill segment across a chunk boundary (chunk "
         "512)", dict(phi3, T=512, q_off=[3500], window=512, kind="chunked")),
        ("grid", f"D 256 decode ({cap}, window 4096)",
         dict(gemma2, T=1, q_off=[6005, 5995], window=4096,
              softcap=CAP_SMALL)),
        ("grid", "D 256 prefill segment (sinks)",
         dict(gemma2, T=512, q_off=[3000], sinks=True)),
        ("grid", "D 256 decode (chunk 4096)",
         dict(gemma2, T=1, q_off=[4095, 4096], window=4096,
              kind="chunked")),
    ]
    cases = []
    for quant in (False, True):
        for route, name, shape in shapes:
            kernel = (("quantized_" if quant else "") + "paged_attention"
                      + ("_dma" if route == "stream" else ""))
            B = len(shape["q_off"])
            cases.append(dict(off, name=name, kernel=kernel, quant=quant,
                              B=B, **shape,
                              kv_len=[o + shape["T"]
                                      for o in shape["q_off"]]))
    return cases


def make_paged_inputs(case, gen):
    """A layer's slice of an arena, as ``forward_paged*`` passes it, and a
    page table of distinct ids per live sequence. Returns (args, kwargs) of
    the case's entry point and of its plain version."""
    dev = "cuda"
    B, T, H, Hkv, D, NP = (case[k] for k in ("B", "T", "H", "Hkv", "D", "NP"))
    page = case["page"]
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
    kw = dict(sliding_window=case["window"], window_kind=case["kind"],
              logit_softcap=case["softcap"], sm_scale=case["sm_scale"])
    if case["sinks"]:
        kw["sinks"] = torch.randn(H, generator=gen, device=dev) * 3.0
    if case["quant"]:
        arena = torch.randint(-127, 128, (2, P, Hkv, page, D), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        # scales of unit-variance tokens: absmax / 127 is about 0.03
        scale = (torch.rand((2, P, page), generator=gen, device=dev) * 0.02
                 + 0.02)
        return (q, arena[0], arena[1], scale[0], scale[1], table, qo, kl), kw
    arena = torch.randn((2, P, Hkv, page, D), generator=gen,
                        device=dev).bfloat16()
    return (q, arena[0], arena[1], table, qo, kl), kw


def paged_combine_cases():
    """The bf16 paged cases that take the split decode (rows 4 and 6 at
    ``DECODE_ROWS`` rows or fewer): row 1's combine merges their
    partials."""
    return [case for case in paged_cases() if not case["quant"]
            and pa.takes_split(case["T"], case["H"] // case["Hkv"])]


def make_paged_combine_inputs(case, gen):
    """The partials the paged split decode gives the combine at ``case``
    (from its plain version, on the card)."""
    args, kw = make_paged_inputs(case, gen)
    part_o, part_ml = pa.paged_split_partials_reference(*args, **kw)
    return part_o, part_ml, case["T"], case["H"] // case["Hkv"]


def paged_plain(case):
    return (pa.quantized_paged_attention_reference if case["quant"]
            else pa.paged_attention_reference)


def paged_live(case):
    """Per sequence: (live (query, key) pairs, live pages). A key is live
    for a query under the causal limit, kv_len and the window; a page is
    live when it holds a key that some query of the sequence sees."""
    pairs, pages = 0, 0
    W, page = case["window"], case["page"]
    for b, (q_off, kv_len) in enumerate(zip(case["q_off"], case["kv_len"])):
        qpos = q_off + np.arange(case["T"])
        hi = np.minimum(qpos, kv_len - 1)  # last live key of each query
        if not W:
            lo = np.zeros_like(qpos)
        elif case["kind"] == "chunked":
            lo = qpos // W * W
        else:
            lo = np.maximum(qpos - W + 1, 0)
        pairs += int(np.maximum(hi - lo + 1, 0).sum())
        if b in case["idle"]:
            continue  # every slot of an idle row is the one null page
        if hi.max() >= lo.min():
            pages += int(hi.max()) // page - int(lo.min()) // page + 1
    return pairs, pages + bool(case["idle"])


def paged_bound(case):
    """Least time (ms) for the work these inputs need: 4*D operations per
    live (query, key) pair and query head; bytes are q and out once, the
    live K/V pages once and, for an int8 arena, their scale rows."""
    pairs, pages = paged_live(case)
    B, T, H, Hkv, D = (case[k] for k in ("B", "T", "H", "Hkv", "D"))
    page = case["page"]
    flops = 4.0 * D * H * pairs
    kv_bytes = 2 * pages * Hkv * page * D * (1 if case["quant"] else 2)
    if case["quant"]:
        kv_bytes += 2 * pages * page * 4
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
# Operations the coders' work needs, whatever implements it; only the 32-bit
# division is taken as the sequence nvcc 12.8 emits for sm_90a (cuobjdump
# -sass): 15 integer instructions. Loads and stores and the division's I2F,
# MUFU.RCP and F2I are left out (they run on the conversion and
# special-function unit).
# Decoder, a symbol: the range shift, code - low, max(range, 1), the
# division (15), the clamp, the symbol search as log2(32) = 5 compares,
# cfn's test and select for the last bin, low += cf * range, cfn - cf,
# range *=, the renormalization test that ends the loop (5), range == 0 and
# the loop's count and test: 38. A renormalization round (one coded byte):
# its test (4), the end-of-stream test and select, the byte's shift out of
# the register window, code << 8 | byte, low <<= 8, range <<= 8: 11 (the
# window's refill, one aligned load every 8 bytes, is left out).
# Encoder, a symbol: cf and cfn (x < 32 and its select; x + 1, its test and
# select), the range shift, low += cf * range, cfn - cf, range *=, the test
# that ends the loop (4) and the loop's count and test: 15. A round: its
# test (3), pos >= cap, the byte's move into the packing register, pos++,
# low <<= 8, range <<= 8: 8; each of the 4 flushed bytes of a stream: 4.
# A stream's rounds are its coded bytes less the 4 of the flush.
# The fused decode adds, a symbol kept in the token window, 10 fp32
# operations: the symbol's conversion, - half, * max, the IEEE division
# (a reciprocal, four fused multiply-adds and the range check: 6) and the
# rounding to the blob's dtype.
DEC_OPS_SYMBOL, DEC_OPS_ROUND = 38, 11
ENC_OPS_SYMBOL, ENC_OPS_ROUND, ENC_OPS_FLUSH_BYTE = 15, 8, 4
DEQ_FP32_OPS = 10
INT32_LANES = 132 * 64  # H100 SXM: 64 INT32 lanes on each of 132 SMs
FP32_LANES = 132 * 128  # and 128 FP32 lanes
ISSUE_LANES = 132 * 128  # 4 schedulers an SM, a warp instruction a clock
PLAIN_STREAMS = 16384  # the plain coders' Python loop is timed at this S
LONGCHAT_CG = CacheGenConfig.from_model_name("lmsys/longchat-7b-16k", 32)
V2_LITE_LAYERS = 27


def coder_cases():
    """The launches the remote paths give the coders: dicts of the kernel,
    the blob geometry of the launch's streams (nchunks, N, L, H, D, T, g;
    streams in (chunk, half, layer, channel group) order, g * T symbols
    each) and the bins of each half's layers. Row 12: tinyllama's store of
    62 chunks (one launch for K and V; the earlier serializer's one half is
    kept beside it), phase 9b's longchat-7b geometry and DeepSeek-V2-Lite's
    latent store (576 channels in groups of 4); row 11 (both entries):
    tinyllama's retrieve group of 16 chunks, 9b's 8 chunks and a V2-Lite
    latent group of 16 chunks."""
    key, value = list(TINY_CG.key_bins), list(TINY_CG.value_bins)
    tiny, longchat = (4, 64, REMOTE_CHUNK, 1), (8, 128, REMOTE_CHUNK, 1)
    latent = (1, MLA_C, REMOTE_CHUNK, 4)
    lat_bins = [CacheGenConfig.for_latent(V2_LITE_LAYERS).key_bins]
    lc = [list(LONGCHAT_CG.key_bins), list(LONGCHAT_CG.value_bins)]
    return [
        {"name": "tinyllama store of 62 chunks, K and V", "kernel":
         "range_encode", "geo": (STORE_CHUNKS, 2, 22) + tiny,
         "bins": [key, value]},
        {"name": "tinyllama store, one half of 62 chunks", "kernel":
         "range_encode", "geo": (STORE_CHUNKS, 1, 22) + tiny, "bins": [key]},
        {"name": "longchat-7b geometry (phase 9b), 8 chunks", "kernel":
         "range_encode", "geo": (8, 2, 32) + longchat, "bins": lc},
        {"name": "DeepSeek-V2-Lite latent store of 62 chunks", "kernel":
         "range_encode", "geo": (STORE_CHUNKS, 1, V2_LITE_LAYERS) + latent,
         "bins": lat_bins},
        {"name": "tinyllama retrieve group, 16 chunks x K and V", "kernel":
         "range_decode", "geo": (GROUP_CHUNKS, 2, 22) + tiny,
         "bins": [key, value]},
        {"name": "longchat-7b geometry (phase 9b), 8 chunks", "kernel":
         "range_decode", "geo": (8, 2, 32) + longchat, "bins": lc},
        {"name": "DeepSeek-V2-Lite latent group of 16 chunks", "kernel":
         "range_decode", "geo": (GROUP_CHUNKS, 1, V2_LITE_LAYERS) + latent,
         "bins": lat_bins},
    ]


def skip_former_coder_draws(gen):
    """Draw from ``gen`` what the coders' inputs drew before they took a
    generator of their own, so that the cases after them get the same
    inputs as before."""
    key = len(TINY_CG.key_bins)
    for planes in (key * STORE_CHUNKS, 2 * key * GROUP_CHUNKS):
        torch.randn((planes, REMOTE_CHUNK, 256), generator=gen, device="cuda")


def coder_inputs(case, seed):
    """Symbols of random-normal bf16 KV quantized with the case's bins, laid
    out as the serializer's streams (uint8 [S, g * T]), their CDFs, the
    maxes [nchunks, N, L, T] and halves [N, L]."""
    nchunks, N, L, H, D, T, g = case["geo"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bins = torch.tensor(case["bins"], dtype=torch.int32, device="cuda")
    x = torch.randn((nchunks * N * L, T, H * D), generator=gen,
                    device="cuda").bfloat16()
    sym, maxes = quant.quantize(x, bins.reshape(-1).repeat(nchunks))
    del x
    streams = sym.transpose(1, 2).reshape(-1, g * T)
    return (streams, quant.stream_cdf(streams),
            maxes[..., 0].reshape(nchunks, N, L, T).contiguous(),
            (bins // 2 - 1).float())


def coded(streams, cdf):
    """Row 12's payload on the card and its int64 offsets [S + 1]."""
    out, lens = re_.encode_streams_raw(streams, cdf)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                         lens.long().cumsum(0)])
    return re_.compact(out, lens), offsets, out, lens


def blob_geo(case, nchunks=None):
    c, N, L, H, D, T, g = case["geo"]
    return dict(nchunks=nchunks or c, L=L, H=H, D=D, T=T, g=g, N=N,
                hf=False, dtype=torch.bfloat16, tok_start=0,
                tok_stop=(nchunks or c) * T)


def hold_coder_against_plain(case, seed):
    """Launch the case's kernels at its shape and hold each against its
    plain version on the same inputs, tolerance 0: row 12's lengths and
    coded bytes of every stream and the copy pass's payload, or row 11's
    symbols and the fused entry's blob bits. Returns {kernel: max abs
    error} (0)."""
    streams, cdf, maxes, half = coder_inputs(case, seed)
    payload, offsets, out, lens = coded(streams, cdf)
    errs = {}
    if case["kernel"] == "range_encode":
        ref_out, ref_lens = re_.encode_streams_reference(streams, cdf)
        ref = re_.compact_reference(ref_out, ref_lens)
        same = torch.equal(lens, ref_lens) and torch.equal(payload, ref)
        errs["range_encode"] = (lens - ref_lens).abs().max().item()
        if same:
            errs["range_encode"] = max(errs["range_encode"], (
                payload.int() - ref.int()).abs().max().item())
        mine = re_.compact_reference(out, lens)
        same_copy = torch.equal(payload, mine)
        errs["range_encode_compact"] = (0 if same_copy else float("inf"))
        same = same and same_copy
        what = (f"{int(lens.sum())} coded bytes of {streams.numel()} symbols"
                f"; the copy pass's payload equals the masked gather: "
                f"{same_copy}")
    else:
        T = streams.shape[1]
        sym = rd.decode_streams(payload, offsets, cdf, T)
        ref = rd.decode_streams_reference(payload, offsets, cdf, T)
        geo = blob_geo(case)
        blob = rd.decode_to_blob(payload, offsets, cdf, maxes, half, **geo)
        want = rd.dequantize_symbols(ref, maxes, half, **geo)
        same_blob = torch.equal(blob.view(torch.int16),
                                want.view(torch.int16))
        same = (torch.equal(sym, ref) and torch.equal(sym, streams)
                and same_blob)
        errs["range_decode"] = max(
            (sym.int() - ref.int()).abs().max().item(),
            (blob.float() - want.float()).abs().max().item())
        what = (f"{sym.numel()} symbols from {payload.numel()} coded bytes; "
                f"the fused entry's bf16 blob {list(blob.shape)} bit-equal "
                f"to the plain decode + dequantization: {same_blob}")
    torch.cuda.synchronize()
    log(f"  {case['kernel']} | {case['name']}: {streams.shape[0]} streams, "
        f"{what}, max_abs_err {errs} (tolerance 0: equal) "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        raise SystemExit(f"{case['kernel']} disagrees with its plain version "
                         f"at {case['name']}")
    return errs


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def coder_bound(int_ops, fp_ops, nbytes, clock_hz):
    """(ms, "operations" or "bytes"): the largest of the integer operations
    at the INT32 lanes' rate, the fp32 ones at the FP32 lanes', all of them
    at the schedulers' issue rate (an fp32 instruction issues beside the
    integer ones, in the clock an INT32 warp instruction leaves free) and
    the bytes at the HBM rate."""
    t_ops = max(int_ops / INT32_LANES, fp_ops / FP32_LANES,
                (int_ops + fp_ops) / ISSUE_LANES) / clock_hz
    t_bytes = nbytes / PEAK_BYTES_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def coder_yardstick(clock_hz):
    """{kernel: rows}: each coder entry at each of its path shapes against
    its bound, its plain version (at about PLAIN_STREAMS streams of the
    same data) and, as no PyTorch call computes a range coder, the host C++
    coder at the same shape (host time, OpenMP threads). Row 12's copy pass
    is timed at the encoder's shapes, the fused decode beside row 11's."""
    rows = {"range_encode": [], "range_encode_compact": [],
            "range_decode": []}
    for i, case in enumerate(coder_cases()):
        name, kernel = case["name"], case["kernel"]
        nchunks, N, L, H, D, T_chunk, g = case["geo"]
        streams, cdf, maxes, half = coder_inputs(case, 100 + i)
        S, T = streams.shape
        payload, offsets, out, lens = coded(streams, cdf)
        coded_bytes = int(lens.sum())
        sym_h, cdf_h = streams.cpu().numpy(), quant.cdf_to_numpy(cdf)
        lens_h = lens.cpu().numpy()
        sub = (streams[:PLAIN_STREAMS], cdf[:PLAIN_STREAMS])
        common = {"shape": name, "streams": S, "symbols": S * T,
                  "coded_bytes": coded_bytes, "library_ms": None,
                  "host_threads": range_coder.num_threads()}
        int_ops = ENC_OPS_SYMBOL * S * T + ENC_OPS_ROUND * (
            coded_bytes - 4 * S) + ENC_OPS_FLUSH_BYTE * 4 * S
        if kernel == "range_encode":
            entries = [("range_encode", "encode_streams_raw",
                        lambda: re_.encode_streams_raw(streams, cdf),
                        lambda: re_.encode_streams_reference(*sub),
                        PLAIN_STREAMS, lambda: range_coder.encode_streams(
                            sym_h, cdf_h), int_ops, 0,
                        S * T + S * 66 + coded_bytes + 4 * S),
                       ("range_encode_compact", "compact",
                        lambda: re_.compact(out, lens, offsets[:-1],
                                            coded_bytes),
                        lambda: re_.compact_reference(out, lens), S, None,
                        0, 0, 2 * coded_bytes + 12 * S)]
        else:
            n_sub = min(nchunks, max(1, PLAIN_STREAMS // (N * L * H * D // g)))
            S_sub = S * n_sub // nchunks
            pay_sub = payload[:int(offsets[S_sub])]
            off_sub, cdf_sub = offsets[:S_sub + 1], cdf[:S_sub]
            geo, geo_sub = blob_geo(case), blob_geo(case, n_sub)
            dec_ops = DEC_OPS_SYMBOL * S * T + DEC_OPS_ROUND * (
                coded_bytes - 4 * S)
            coded_in = coded_bytes + S * 66 + 8 * (S + 1)
            pay_h = payload.cpu().numpy()
            entries = [
                ("range_decode", "decode_streams",
                 lambda: rd.decode_streams(payload, offsets, cdf, T),
                 lambda: rd.decode_streams_reference(pay_sub, off_sub,
                                                     cdf_sub, T),
                 S_sub, lambda: range_coder.decode_streams(
                     pay_h, lens_h, T, cdf_h), dec_ops, 0, coded_in + S * T),
                ("range_decode", "decode_to_blob",
                 lambda: rd.decode_to_blob(payload, offsets, cdf, maxes,
                                           half, **geo),
                 lambda: rd.dequantize_symbols(rd.decode_streams_reference(
                     pay_sub, off_sub, cdf_sub, T), maxes[:n_sub], half,
                     **geo_sub),
                 S_sub, None, dec_ops, DEQ_FP32_OPS * S * T,
                 coded_in + maxes.numel() * 4 + half.numel() * 4
                 + 2 * S * T)]
        for (row_kernel, entry, fn, plain, plain_streams, host, iops, fops,
             nbytes) in entries:
            ms = cuda_ms(fn, iters=10)
            plain_ms = cuda_ms(plain, iters=1, warmup=1)
            host_ms = wall_best(host, n=1) if host else None
            bound_ms, bound_by = coder_bound(iops, fops, nbytes, clock_hz)
            row = {**common, "entry": entry, "ms": ms, "plain_ms": plain_ms,
                   "plain_streams": plain_streams, "host_coder_ms": host_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_int_operations": iops, "bound_fp32_operations": fops,
                   "bound_bytes": nbytes}
            host_txt = (f", host C++ coder {host_ms:.1f} ms "
                        f"({common['host_threads']} threads)" if host else "")
            log(f"  {row_kernel} | {name} ({entry}): kernel {ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}: {iops / 1e9:.3f} G "
                f"integer and {fops / 1e9:.3f} G fp32 operations at "
                f"{clock_hz / 1e6:.0f} MHz, {nbytes / 1e6:.1f} MB), "
                f"{ms / bound_ms:.2f}x the bound; plain {plain_ms:.1f} ms at "
                f"{plain_streams} streams{host_txt}; no PyTorch call "
                f"computes it")
            rows[row_kernel].append(row)
        del streams, cdf, out, lens, payload, offsets
        torch.cuda.empty_cache()
    return rows


# ------------------------------- rows 8, 9 and 10: MLA latent attention ---

MLA_CFG = mla.MLAConfig.deepseek_v2_lite()  # H 16, latent 576 = 512 + 64
MLA_HEADS_V3 = mla.MLAConfig.deepseek_v3().n_heads  # 128, the same latent
MLA_SERVE_SEQ = 2048 + 64  # phases 10b and 10c: max_seq of the engines
NP_MLA = -(-(MLA_SERVE_SEQ + 1) // PAGE)
MLA_C, MLA_CP = MLA_CFG.latent_dim, mla.latent_pad_dim(MLA_CFG)
MLA_R = MLA_CFG.kv_lora_rank
# a latent case's geometry (:func:`latent_cases`' keys H, C, R and scale)
MLA_GEOMETRY = dict(H=MLA_CFG.n_heads, C=MLA_C, R=MLA_R,
                    scale=MLA_CFG.sm_scale)


def latent_cases():
    """The shapes phase 10 gives kernel rows 8-10 at DeepSeek-V2-Lite (H 16,
    C 576, rank 512), for the bf16 and the int8 latents, and decode with
    H 128, the geometry of DeepSeek-V2 and V3 (whose weights do not fit one
    card). Keys: kernel, B, T, H, C, R (rank), scale, q_off, kv_len; S
    (dense rows) or NP (page slots; ``idle`` rows point every slot at the
    null page 0, as the engine's parked decode rows do). The first case of
    a kernel is the one its path gives it first."""
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
    base = dict(MLA_GEOMETRY, idle=[])
    cases = []
    for quant in (False, True):
        pre = "quantized_" if quant else ""
        for name, shape in dense:
            cases.append(dict(base, **shape, name=name, quant=quant,
                              paged=False,
                              kernel=pre + "latent_flash_attention"))
        # row 10 on every paged shape; row 9 where phase 10d gives it work
        for name, shape in paged:
            for kernel in ("paged_latent_attention_dma",
                           "paged_latent_attention"):
                if kernel == "paged_latent_attention" and "16k" in name:
                    continue
                cases.append(dict(base, **shape, name=name, quant=quant,
                                  paged=True, kernel=pre + kernel))
    for case in cases:
        case["kv_len"] = [o + case["T"] for o in case["q_off"]]
    return cases


def quality_latent_cases():
    """Row 8 at phase 15's trained MLA checkpoint (H 4, C 160 = 128 + 32,
    rank 128), bf16 and int8 latents: the context's prefill, the
    continuation's over it and a decode at the end of its pool."""
    qcfg = quality_common.quality_mla_config()
    base = dict(B=1, S=QUALITY_S, H=qcfg.n_heads, C=qcfg.latent_dim,
                R=qcfg.kv_lora_rank, scale=qcfg.sm_scale, idle=[],
                paged=False)
    cases = []
    for quant in (False, True):
        for name, T, q_off in (
                ("quality-mla context prefill", QUALITY_CTX, 0),
                ("quality-mla continuation", QUALITY_CONT, QUALITY_CTX),
                ("quality-mla decode", 1, QUALITY_S - 1)):
            cases.append(dict(base, name=name, T=T, q_off=[q_off],
                              kv_len=[q_off + T], quant=quant,
                              kernel=("quantized_" if quant else "")
                              + "latent_flash_attention"))
    return cases


def make_latent_inputs(case, gen):
    """(positional args, kwargs) of the case's entry point: dense latents
    [B, S, C] as a layer of the pool, or a lane-padded arena [P, page, Cp]
    (zero pad) with a fragmented page table; int8 latents with scales of
    unit-size tokens."""
    dev = "cuda"
    B, T, H, C = case["B"], case["T"], case["H"], case["C"]
    q = torch.randn((B, T, H, C), generator=gen, device=dev).bfloat16()
    if case["paged"]:
        P = B * case["NP"] + 1
        shape = (P, PAGE, MLA_CP)
    else:
        shape = (B, case["S"], C)
    if case["quant"]:
        rows = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        # unit-size latents: absmax / 127 is about 0.03
        lat = (rows, torch.rand(shape[:2], generator=gen, device=dev) * 0.02
               + 0.02)
    else:
        lat = (torch.randn(shape, generator=gen, device=dev).bfloat16(),)
    if case["paged"]:
        lat[0][..., C:] = 0  # the lane pad, as the model writes it
    qo = torch.tensor(case["q_off"], dtype=torch.int32, device=dev)
    kl = torch.tensor(case["kv_len"], dtype=torch.int32, device=dev)
    kw = dict(rank=case["R"], scale=case["scale"])
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


def latent_combine_cases():
    """The cases of :func:`latent_cases` whose row-10 launch runs the key
    split (bf16 latents: the combine reads fp32 partials either way)."""
    return [case for case in latent_cases()
            if case["kernel"] == "paged_latent_attention_dma"
            and pla.takes_split(case["T"], case["H"])]


def make_latent_combine_inputs(case, gen):
    """The partials row 10's split decode gives the combine at ``case``
    (from the plain split version, on the card)."""
    args, kw = make_latent_inputs(case, gen)
    q, pool, table, qo, kl = args
    part_o, part_ml = pla.paged_latent_split_partials_reference(
        q, pool, table, qo, kl, **kw)
    return part_o, part_ml, case["T"], case["H"]


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
    C, R = case["C"], case["R"]
    flops = 2.0 * H * (C + R) * pairs
    per_row = C + 4 if case["quant"] else 2 * C
    nbytes = (2 * B * T * H * (C + R) + len(rows) * per_row)
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
    B, T, H, C, R = case["B"], case["T"], case["H"], case["C"], case["R"]
    if case["paged"]:
        n_live = -(-max(case["kv_len"]) // PAGE)
        ids = args[-3][:, :n_live].long()

        def dense():
            x = args[1][ids][..., :C]  # [B, n, page, C]
            if case["quant"]:
                x = (x.float() * args[2][ids][..., None]).bfloat16()
            return x.reshape(B, n_live * PAGE, C)
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
    k = lat[:, None].expand(B, H, S, C)
    v = lat[:, None, :, :R].expand(B, H, S, R)
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


# ------------------------- the verification shape of spec_lookahead ---

# a verification forward: T = SPEC_K + 1 a row over four rows of different
# kv_len (the pool of phase 4's engine with the horizon SPEC_K + 1 past
# S); every row's K/V past its kv_len is random (live garbage), as the
# rejected proposals of earlier verifications leave it
VERIFY_T = 5
VERIFY_S = 2048 + 64 + VERIFY_T
VERIFY_OFF = [2080, 1500, 700, 31]


def verify_cases():
    """(family, case) at the verification shape for kernel rows 1, 3 (the
    dense cases' format), 4-7 (paged: tinyllama D 64, the streaming rows 6
    and 7, whose 40 rows a block take the body; Phi-3 D 96, rows 4 and 5,
    whose 5 rows take the split) and 8-10 (latent: V2-Lite, 80 rows: row
    10's split, row 8's body and row 9's page steps), bf16 and int8."""
    off = dict(window=None, kind="sliding", softcap=None, sinks=False,
               sm_scale=None, pool_rows=None, slot=None)
    tiny = dict(H=32, Hkv=4, D=64)
    kv_len = [o + VERIFY_T for o in VERIFY_OFF]
    cases = [("dense", dict(off, name="tinyllama verification, T 5 x 4 rows",
                            kernel=k, B=4, T=VERIFY_T, S=VERIFY_S,
                            q_off=VERIFY_OFF, kv_len=kv_len, **tiny))
             for k in ("flash_attention", "quantized_flash_attention")]
    shapes = [
        dict(name="tinyllama verification, T 5 x 4 rows", B=4, T=VERIFY_T,
             q_off=VERIFY_OFF, NP=-(-VERIFY_S // PAGE), H=32, Hkv=4, D=64,
             window=None),
        dict(name="phi3 verification, T 5 x 4 rows", B=4, T=VERIFY_T,
             q_off=[3010, 2990, 1200, 40], NP=NP_PHI3, H=32, Hkv=32, D=96,
             window=PHI3_WINDOW)]
    for quant in (False, True):
        for shape in shapes:
            kernel = (("quantized_" if quant else "") + "paged_attention"
                      + ("_dma" if shape["D"] == 64 else ""))
            cases.append(("paged", dict(
                {**PAGED_OFF, **shape}, kernel=kernel, quant=quant,
                kv_len=[o + VERIFY_T for o in shape["q_off"]],
                table="fragmented", idle=[])))
    mla_off = [2060, 1500, 700, 31]
    for quant in (False, True):
        pre = "quantized_" if quant else ""
        base = dict(MLA_GEOMETRY, idle=[], B=4, T=VERIFY_T,
                    q_off=mla_off, kv_len=[o + VERIFY_T for o in mla_off],
                    quant=quant, name="v2-lite verification, T 5 x 4 rows")
        cases.append(("latent", dict(base, S=MLA_SERVE_SEQ + VERIFY_T,
                                     paged=False,
                                     kernel=pre + "latent_flash_attention")))
        for kernel in ("paged_latent_attention_dma",
                       "paged_latent_attention"):
            cases.append(("latent", dict(base, NP=NP_MLA, paged=True,
                                         kernel=pre + kernel)))
    return cases


def verify_call(family, case, gen):
    """(kernel, the call, its plain version, its library call (ms) or None,
    (bound ms, bound by)) of a verification case, on inputs drawn from
    ``gen``."""
    if family == "dense":
        q, kv, qo, kl, kw = make_dense_inputs(case, gen)

        def library(iters):
            deq, sdpa = dense_library(case, q, kv, qo, kl, iters)
            return None if sdpa is None else (deq or 0.0) + sdpa
        return (case["kernel"], lambda: dense_call(case, q, kv, qo, kl, kw),
                lambda: dense_plain(case, q, kv, qo, kl, kw), library,
                dense_bound(case))
    if family == "paged":
        args, kw = make_paged_inputs(case, gen)
        entry, plain = KERNELS[case["kernel"]][0], paged_plain(case)

        def library(iters):
            gather, sdpa = paged_library(case, args, iters)
            return None if sdpa is None else gather + sdpa
        return (case["kernel"], lambda: entry(*args, **kw),
                lambda: plain(*args, **kw), library, paged_bound(case))
    args, kw = make_latent_inputs(case, gen)
    entry = KERNELS[case["kernel"]][0]

    def library(iters):
        pre, sdpa, _ = latent_library(case, args, kw, iters)
        return (pre or 0.0) + sdpa
    return (case["kernel"], lambda: entry(*args, **kw),
            lambda: latent_plain(case, args, kw), library,
            latent_bound(case, args))


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
    # the full prefill's window checked against CUDA events (its 900-odd
    # launches overflow the launch queue behind a spin, so not queued): the
    # span from an event before its first launch to one after its last,
    # which bounds its device time from above, against the profiler's sum
    # of kernel times, which loses records where it undercounts
    prof = profile[0]
    span_ms, host_ms = event_span_ms(lambda: prefill_full())
    log(f"  full prefill window: device {prof['device_ms']} ms by the "
        f"profiler, at most {span_ms:.3f} ms by events (their span); idle "
        f"share {prof.get('idle_share')} by the profiler, at least "
        f"{1 - span_ms / host_ms:.4f} by events over {host_ms:.3f} ms of "
        f"host time (no profiler)")
    prof["events_span_ms"], prof["events_host_ms"] = span_ms, host_ms
    engine.close()
    return {"ttft_full_ms": t_full, "ttft_reuse_ms": t_reuse,
            "speedup": t_full / t_reuse, "profile": profile,
            "full_logits": full_logits}


def profile_window(name, fn, top=5, watch=None, copies=False):
    """One warm run of ``fn`` under ``torch.profiler``: host time, summed
    kernel time, device idle share (1 - kernel / host time; one stream, so
    kernels do not overlap) and the kernels that took the most time, and
    those whose name matches the regular expression ``watch`` wherever they
    rank; with ``copies``, the host-to-device copies from pageable and from
    pinned memory (count, ms). Host time includes the profiler's own
    overhead."""
    from torch.profiler import ProfilerActivity, profile
    # the device's activity only: recording every host op as well cost
    # seconds a window at a large model's thousands of launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    watched = [(ms, c, k) for ms, c, k in by_time
               if watch and re.search(watch, k)]
    for ms, count, key in watched:
        log(f"    watched: {ms:10.3f} ms x{count:<5d} {key[:90]}")
    h2d = {}
    for ms, count, key in by_time:
        m = re.search(r"HtoD \((Pageable|Pinned)", key)
        if m:
            c, t = h2d.get(m.group(1).lower(), (0, 0.0))
            h2d[m.group(1).lower()] = (c + count, t + ms)
    if copies:
        log("    host -> device copies: " + ", ".join(
            f"{kind} x{c} {t:.3f} ms" for kind, (c, t) in sorted(h2d.items()))
            if h2d else "    host -> device copies: none recorded")
    return {"window": name, "host_ms": host_ms, "device_ms": device_ms,
            "idle_share": idle, "h2d": h2d,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in by_time[:top]],
            "watched": [{"kernel": k, "ms": ms, "count": c}
                        for ms, c, k in watched]}


# the attention kernels a profiled paged step shows wherever they rank: the
# Hopper body, the split decode and its combine
ATTENTION_KERNELS = r"flash_sm90_fwd|decode_split_fwd|combine_partials_fwd"


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


def _bf16_step(x):
    """The spacing of bf16 values at the magnitude of ``x`` (fp32): 8
    significand bits, so 2 ** (floor(log2 |x|) - 7)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _logits_agree(name, got, want, tol=REL_L2_REUSE, same_top1=True,
                  near_tie=False, flips=None, ties=None):
    """Relative L2 within ``tol`` and (unless ``same_top1`` is off) the
    same top-1, per request. With ``near_tie`` the top-1 may instead be a
    token that ``want`` itself puts within ``TOP1_MARGIN`` of its best.
    ``ties`` gives, per request, the fp32 logits of the plain-attention
    forward with its LM head in fp32 (:func:`plain_first_logits`): two
    first tokens that differ count as the same top-1 only where their fp32
    logits there lie within ``TIE_STEPS`` bf16 steps at their magnitude
    (:func:`_bf16_step` of the larger); each such gap is printed.
    ``flips`` gives, per request, the (MoE layer, token) top-k sets in which
    the two computations differ and those compared (:class:`Routing`): a
    request whose routing flipped is held to ``REL_L2_MOE``, every other to
    ``tol``; the distance
    between two requests' reference logits, what a wrong request would
    give, is printed beside them."""
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    same_top = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    tied = [False] * len(same_top)
    gaps = []
    if ties is not None:
        for i, (s, g, w, r) in enumerate(zip(same_top, got, want, ties)):
            if s:
                continue
            a, b = r[int(g.argmax())], r[int(w.argmax())]
            steps = ((a - b).abs() / _bf16_step(torch.maximum(a.abs(),
                                                             b.abs()))).item()
            gaps.append((i, (a - b).item(), steps))
            tied[i] = steps <= TIE_STEPS
        same_top = [s or t for s, t in zip(same_top, tied)]
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
    for i, gap, steps in gaps:
        verdict = "a tie" if steps <= TIE_STEPS else "not a tie"
        note += (f" (request {i}: first tokens differ; the fp32 witness "
                 f"puts them {gap:.6e} apart, {steps:.4f} bf16 steps, at "
                 f"most {TIE_STEPS}: {verdict})")
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
    """The routed experts that an MoE model's layers pick for each token a
    watched engine computes (DeepSeek-V2-Lite in phase 10, Qwen3-MoE in
    phase 13b). While it is entered, the model's routing function is
    wrapped: ``mla._gate``, or ``llama._route`` with ``model="llama"``. ``watch(eng)`` makes each forward of ``eng``
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
    gate's weights are taken at the forced experts, as the routing function
    takes them. Outside an engine, :func:`routed` records or forces one
    bare forward."""

    def __init__(self, model="mla"):
        self.module, self.name = ((llama, "_route") if model == "llama"
                                  else (mla, "_gate"))
        self.rows = None  # (req, position) or None per row of the forward
        self.picks = []  # the forward's top-k ids, one tensor per MoE layer
        self.force = None  # [n_moe, rows, k] forced ids, -1 where free
        self.swapped = 0  # (layer, token) sets replaced under force
        self.wave1 = {}  # the dense engine's (wave 1 record, requests)

    def __enter__(self):
        self.gate = getattr(self.module, self.name)
        setattr(self.module, self.name, self._gate)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.gate)

    def _weights(self, h, lp, cfg, ids):
        """The routing weights of experts ``ids`` of tokens ``h``."""
        if self.module is llama:
            return llama._route_weights(llama._router_logits(h, lp, cfg),
                                        ids, cfg)
        logits = h.float() @ lp["router"].float()
        scores = (torch.sigmoid(logits) if cfg.arch == "v3"
                  else torch.softmax(logits, dim=-1))
        w = torch.gather(scores, -1, ids)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return w * cfg.routed_scaling_factor

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
                w = self._weights(h, lp, cfg, want.clamp(min=0))
                topi = torch.where(swap[:, None], want, topi)
                topw = torch.where(swap[:, None], w, topw)
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


def routed(routing, fn, force=None):
    """``fn()``, one bare forward, with its expert choices recorded:
    (its result, the sorted top-k ids [n_moe, rows, k]); routed as
    ``force`` ([n_moe, rows, k] sorted ids, -1 where free) where given."""
    routing.rows, routing.picks, routing.force = True, [], force
    try:
        out = fn()
    finally:
        routing.rows, routing.force = None, None
    return out, torch.stack(routing.picks).sort(dim=-1).values


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
# wave 4's prompts: the waves' prompts extended to 3 tokens short of 33
# pages, so that decode needs a 34th page at its 4th token; WAVE4_NEW tokens
# each
WAVE4_LEN = 33 * PAGE - 3
WAVE4_NEW = 12


def _tier(name, cfg):
    return LMCacheEngine(
        LMCacheEngineConfig(local_device="cuda"),
        LMCacheEngineMetadata(model_name=name, world_size=1, worker_id=0,
                              fmt="vllm", dtype=cfg.dtype))


def paged_engine(cfg, params, engine_cls=PagedServingEngine, routing=None,
                 **kw):
    """A PagedServingEngine (page 64, 512-token prefill segments unless
    ``prefill_chunk`` says otherwise) that keeps
    what the checks read: ``prefill_logits[request_id]``, one ``(tokens
    sampled before, logits)`` per completed prefill (the first token; then
    one per resume after a preemption), ``injected_pages``, the number of
    pages written by ``_inject_pages``, ``injected``, its (blob, pages)
    calls, and ``decode_logits``, the logits of every batched decode step
    once ``keep_decode_logits`` is set. A :class:`Routing` watches it."""
    eng = engine_cls(cfg, params, page_size=PAGE,
                     **{"prefill_chunk": 512, **kw})
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


def plain_first_logits(cfg, params, prompts, kv_dtype="native",
                       every=False):
    """The first-token logits of each prompt through the dense forward
    with the plain attention (the kernels' plain version, fp32 inside;
    over an int8 pool for ``kv_dtype="int8"``), one prompt a call, with the
    LM head in fp32: the final norm's fp32 output times the fp32 head
    weights (the engines round the norm's output and the logits to bf16).
    Where two kernel paths put different tokens first, this says how far
    apart the two tokens' logits lie in fp32. With ``every``, the logits
    at every position of each prompt ([T, V])."""

    def lm_logits_fp32(x, params, cfg):
        x32 = x.float()
        h = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                              + cfg.norm_eps)
        w = params["final_norm"].float()
        h = h * (1.0 + w) if cfg.norm_one_offset else h * w
        logits = h @ params["lm_head"].float()
        if cfg.final_logit_softcap is not None:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = []
    bf16_head = llama._lm_logits
    llama._lm_logits = lm_logits_fp32  # forward's LM head, for this witness
    try:
        for p in prompts:
            toks = torch.as_tensor(np.asarray(p), device="cuda").long()[None]
            fwd, new = ((llama.forward_quantized,
                         llama.new_quantized_kv_cache) if kv_dtype == "int8"
                        else (llama.forward, llama.new_kv_cache))
            logits, _ = fwd(params, cfg, toks, zero,
                            new(cfg, 1, toks.shape[1]),
                            last_logit_only=not every, use_kernel=False)
            out.append(logits[0] if every else logits[0, -1])
    finally:
        llama._lm_logits = bf16_head
    return out


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


def profile_decode_step(eng, prompts, arena, prefill=False, model="paged"):
    """Bring the prompts to decode, then time and profile one batched
    decode step (tinyllama: 3 of the 4 rows live, the fourth parked on the
    null page). With ``prefill`` the prompts' first tokens change, so that
    no page is resident or cached, and the first engine step, a step of
    512-token prefill segments, is profiled too (``prof["prefill"]``)."""
    if prefill:
        prompts = [np.concatenate([[(int(p[0]) + 1) % eng.cfg.vocab_size],
                                   np.asarray(p)[1:]]).astype(np.int64)
                   for p in prompts]
    for p in prompts:
        eng.add_request(Request(p, SamplingParams(max_new_tokens=16)))
    prefill_prof = (profile_window(f"{model} prefill step, {arena} arena, "
                                   f"fresh prompts (512-token segments)",
                                   eng.step, watch=ATTENTION_KERNELS)
                    if prefill else None)
    while eng.waiting or eng.prefilling:
        eng.step()
    step_ms = wall_best(eng.step)
    prof = profile_window(f"{model} decode step, {arena} arena, "
                          f"{len(prompts)} of {eng.B} rows live (step alone "
                          f"{step_ms:.3f} ms, best of 3)", eng.step,
                          watch=ATTENTION_KERNELS)
    eng.run()
    prof["step_ms"] = step_ms
    if prefill_prof is not None:
        prof["prefill"] = prefill_prof
    return prof


def paged_tinyllama_waves(cfg, params, prompts, dense_logits, kv_dtype,
                          engine_cls=PagedServingEngine,
                          model="tinyllama-1.1b", max_new=32,
                          after_wave3=None, near_tie=False, routing=None,
                          profile_prefill=False):
    """The four waves over one arena dtype (``engine_cls`` and ``model``
    serve another family: phase 10c; ``after_wave3(engine)`` adds a check
    of wave 3's engine; ``near_tie`` admits phase 6d's top-1 rule;
    ``profile_prefill`` adds a window of a prefill step). With a
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

    def replayed(name, want_record, num_pages=256, new=max_new,
                 wave=prompts, **over):
        """A fresh engine's wave of ``wave`` routed as ``want_record``."""
        routing.swapped = 0
        again = paged_engine(cfg, params, num_pages=num_pages,
                             **dict(kw, **over))
        reqs, logits, _, _ = paged_wave(again, name, wave, new,
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
        ties = (None if routing is not None
                else plain_first_logits(cfg, params, prompts))
        ok = _logits_agree("wave 1 vs the dense engine's wave 1", l1,
                           dense_logits, near_tie=near_tie, flips=f1,
                           ties=ties)
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
    profile = profile_decode_step(eng, prompts, arena,
                                  prefill=profile_prefill)

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

    # wave 4: the prompts extended to WAVE4_LEN tokens, so that decode
    # crosses a page boundary at its 4th token; first on a roomy arena,
    # then on one that cannot hold three requests of 34 pages. Both engines
    # are fresh and restore the first `hit` tokens from the tier; their
    # segments after it end with the last prompt token alone, so that the
    # two compute in the same shapes (whatever the roomy one stored back)
    # and decode the same tokens up to the preemption.
    ext = np.random.default_rng(4)
    prompts4 = [np.concatenate([p, ext.integers(0, cfg.vocab_size,
                                                WAVE4_LEN - len(p))])
                for p in prompts]
    kw4 = dict(kw, prefill_chunk=WAVE4_LEN - 1 - hit)
    long_new = WAVE4_NEW
    eng = paged_engine(cfg, params, num_pages=256, **kw4)
    eng.keep_decode_logits = True
    ref, l_ref, _, rec_ref = paged_wave(
        eng, "wave 4 reference (roomy arena)", prompts4, long_new)
    tight = paged_engine(cfg, params, num_pages=TIGHT_PAGES, **kw4)
    w4, l4, _, _ = paged_wave(tight, f"wave 4 (arena of {TIGHT_PAGES - 1} "
                              f"pages)", prompts4, long_new)
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
                                  num_pages=TIGHT_PAGES, new=long_new,
                                  wave=prompts4,
                                  prefill_chunk=kw4["prefill_chunk"])
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


def paged_full_depth(cfg, params, model, prompts, num_pages,
                     near_tie=False):
    """A ``PagedServingEngine`` on ``cfg`` at full width and depth over a
    bf16 and then an int8 arena: the two prompts, 16 new tokens; the logits
    of the last prompt token held against ``forward_paged*`` with the plain
    attention on the same arena (``near_tie``: phase 6d's top-1 rule); one
    ``torch.profiler`` window over a prefill step of two fresh prompts and
    one over a decode step, per arena. Returns (launch counts by arena, the
    profiles)."""
    launches, first, profiles = {}, {}, []
    for kv_dtype, arena in (("native", "bf16"), ("int8", "int8")):
        log(f"  -- {arena} arena")
        reset_launch_counts()
        eng = paged_engine(cfg, params, max_batch=2,
                           max_seq=cfg.max_seq_len, num_pages=num_pages,
                           prefill_token_budget=2 * 512, kv_dtype=kv_dtype)
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
        launches[f"paged {model} {arena}"] = read_launch_counts()
        finite = all(bool(torch.isfinite(l).all()) for l in first[arena])
        if not (finite and _logits_agree(
                "last prompt token vs forward_paged with the plain attention",
                first[arena], [plain[r.request_id] for r in reqs],
                near_tie=near_tie)):
            raise SystemExit(f"{model} {arena} arena: the kernel path "
                             f"disagrees with the plain attention")
        # a step of two fresh prompts' 512-token segments, then a decode
        # step of both rows
        eng._prefill_segment = segment
        profiles.append(profile_decode_step(eng, prompts, arena, prefill=True,
                                            model=f"{model} paged"))
        del eng, plain
        torch.cuda.empty_cache()
    if not _logits_agree("int8 arena vs bf16 arena", first["int8"],
                         first["bf16"], REL_L2_INT8, same_top1=False):
        raise SystemExit(f"{model}: the int8 arena's logits left the bf16 "
                         f"arena's")
    return launches, profiles


def free_device_memory():
    """Collect the engines an earlier phase left in reference cycles (the
    checks wrap an engine's methods in closures over the engine) with the
    weights they hold, and return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def draw_params(cfg):
    """Random bf16 weights of ``cfg`` from a generator seeded 0, drawn after
    :func:`free_device_memory`; logs their size and the time to draw
    them."""
    free_device_memory()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() * t.element_size() for t in (
        [params[k] for k in ("embed", "final_norm", "lm_head")]
        + list(params["layers"].values())))
    log(f"  weights {n / 1e9:.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def phase_paged_phi3():
    log("== phase 6: PagedServingEngine, Phi-3-mini-4k (D 96, window 2047), "
        "full width and depth")
    cfg = llama.LlamaConfig.phi3_mini_4k()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3000, 2987)]
    return paged_full_depth(cfg, draw_params(cfg), "phi3", prompts, 128)


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


def start_cache_server(wait=True):
    """The port's cache server in a subprocess on a free port: (process,
    ``lm://`` URL). With ``wait`` it fails the phase unless the server
    answers within 15 s; without, :func:`await_cache_server` does that
    later, so that the server starts while other work runs."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "lmcache_tpu_torch.server",
                             "localhost", str(port), "cpu"])
    url = f"lm://localhost:{port}"
    if wait:
        await_cache_server(proc, url)
    return proc, url


def await_cache_server(proc, url, timeout=15):
    import socket
    port = int(url.rsplit(":", 1)[1])
    deadline = time.time() + timeout
    while True:
        try:
            socket.create_connection(("localhost", port), timeout=0.5).close()
            return
        except OSError:
            if time.time() > deadline or proc.poll() is not None:
                stop_process(proc)
                raise SystemExit(f"the cache server did not answer in "
                                 f"{timeout} s")
            time.sleep(0.05)


def stop_process(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


TRANSPORTS = ("python", "native")  # phase 9's order: the native one last


def remote_tier(url, cfg, transport="native", model_name=REMOTE_MODEL,
                **kw):
    """A remote CacheGen tier over the cache server at ``url``, talking
    through the native transport (the connector's default) or the Python
    socket client (``use_native=False``)."""
    tier = LMCacheEngine(
        LMCacheEngineConfig(local_device=None, remote_url=url,
                            remote_serde="cachegen", chunk_size=REMOTE_CHUNK,
                            **kw),
        LMCacheEngineMetadata(model_name=model_name, world_size=1,
                              worker_id=0, fmt="vllm", dtype=cfg.dtype))
    if transport == "python":
        host, port = url.split("://")[1].rsplit(":", 1)
        tier.engine_.connection.close()
        tier.engine_.connection = LMCServerConnector(host, int(port),
                                                     use_native=False)
    if (tier.engine_.connection.native is None) != (transport == "python"):
        raise SystemExit(f"remote tier: not on the {transport} transport")
    return tier


def remote_store(url, cfg, tokens_np, prefix):
    """Instance A stores the CTX prefix (row 12, one launch for both halves,
    and its copy pass); every container must equal the host C++ coder's;
    the card's quantization and CDF must equal the CPU's; a second pass
    splits the encode into its parts."""
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
    wire = [bytes(a.engine_.connection.get(k.to_string())) for k in keys]
    a.close()
    py = remote_tier(url, cfg, transport="python")
    same_py = sum(py.engine_.connection.get(k.to_string()) == w
                  for k, w in zip(keys, wire))
    py.close()
    log(f"  the containers fetched through the native transport equal those "
        f"fetched through the Python client: {same_py} of {len(wire)}")
    if same_py != len(wire):
        raise SystemExit("remote store: the transports fetch other bytes")
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


@contextmanager
def uncounted():
    """Launches made inside (checks of a path against its references) are
    not the path's: every count is put back as it was."""
    saved = {name: Counter(w.launches) for name, (w, _, _) in KERNELS.items()}
    try:
        yield
    finally:
        for name, (w, _, _) in KERNELS.items():
            w.launches.clear()
            w.launches.update(saved[name])


def same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


@contextmanager
def keeping_fused_decodes():
    """Within the block, each call of row 11's fused entry (the remote
    path's decode) keeps its inputs and blob in the list it yields."""
    groups, fused = [], rd.decode_to_blob

    def fused_and_keep(payload, offsets, cdf, maxes, half, **geo):
        blob = fused(payload, offsets, cdf, maxes, half, **geo)
        groups.append((payload, offsets, cdf, maxes, half, geo, blob))
        return blob

    rd.decode_to_blob = fused_and_keep
    try:
        yield groups
    finally:
        rd.decode_to_blob = fused


def fused_decodes_exact(groups):
    """For each kept fused decode: (its streams' symbols decoded on the card
    equal the host C++ decode, its blob is those symbols dequantized bit for
    bit). These checks' launches are not counted."""
    checks = []
    with uncounted():
        for payload, offsets, cdf, maxes, half, geo, blob in groups:
            n = geo["g"] * geo["T"]
            sym = rd.decode_streams(payload, offsets, cdf, n)
            host = range_coder.decode_streams(
                payload.cpu().numpy(), np.diff(offsets.cpu().numpy()), n,
                quant.cdf_to_numpy(cdf))
            checks.append((
                bool(np.array_equal(sym.cpu().numpy(), host)),
                same_bits(blob, rd.dequantize_symbols(sym, maxes, half,
                                                      **geo))))
    return checks


def remote_reuse_gate(url, cfg, params, tokens_np, full_logits, transport):
    """Instance B (pipelined, on ``transport``) serves the CTX + SUFFIX
    prompt: grouped inject (row 11's fused entry, one launch a group), then
    the suffix prefill. Gates: the cached prefix; every group's symbols,
    decoded again on the card, equal the host C++ decode of its containers,
    and its blob those symbols dequantized; the slot equals retrieve() with
    the host decoder injected into a second slot. Returns the engine and
    the request's slot (read by the paged wave and across transports)."""
    log(f"  -- {transport} transport")
    b = remote_tier(url, cfg, transport, pipelined_backend=True)
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=CTX + SUFFIX + 8,
                        cache_engine=b)
    kept = {}
    finish = eng._finish_prefill

    def finish_and_keep(req, logits):
        kept[req.request_id] = logits.float().clone()
        finish(req, logits)

    eng._finish_prefill = finish_and_keep
    with keeping_fused_decodes() as groups:
        [req] = eng.generate([tokens_np], SamplingParams(max_new_tokens=1))
    b.engine_.flush()
    group_sizes = [g[1].numel() - 1 for g in groups]
    checks = fused_decodes_exact(groups)
    same_symbols = [c[0] for c in checks]
    same_blobs = [c[1] for c in checks]
    off = remote_tier(url, cfg, transport, cachegen_device_decode="off")
    blob, mask = off.retrieve(tokens_np[:CTX], return_tuple=False)
    off.close()
    other = 1 - req.slot
    eng._inject(blob, other, 0)
    same_kv = torch.equal(eng.kv_pool[:, :, req.slot, :, :CTX],
                          eng.kv_pool[:, :, other, :, :CTX])
    logits = kept[req.request_id]
    rel = ((logits - full_logits).norm() / full_logits.norm()).item()
    log(f"  reuse: cached_prefix_len {req.cached_prefix_len}; fused decode "
        f"groups of {group_sizes} streams; symbols equal the host C++ decode "
        f"{same_symbols}; blobs equal those symbols dequantized "
        f"{same_blobs}; slot KV equals retrieve() with the host decoder "
        f"injected into slot {other}: {same_kv}")
    log(f"  first-token logits against the full prefill's (CacheGen is "
        f"lossy, random-init KV its worst case; reported): rel_l2 {rel:.4e}, "
        f"top-1 {int(logits.argmax())} vs {int(full_logits.argmax())}")
    if not (req.cached_prefix_len >= CTX - 1
            and len(groups) == -(-STORE_CHUNKS // GROUP_CHUNKS)
            and all(same_symbols) and all(same_blobs) and same_kv
            and int(mask.sum()) == CTX
            and bool(torch.isfinite(logits).all())):
        raise SystemExit("remote reuse: a gate failed")
    return eng, req.slot, {"cached_prefix_len": req.cached_prefix_len,
                 "reuse_rel_l2": rel,
                 "same_top1": int(logits.argmax()) == int(
                     full_logits.argmax())}


def remote_stage_split(url, cfg, params, tokens, tokens_np, transport):
    """bench.py:470-526's stages, one measured pass each, over the 62
    containers in the engine's groups of 16: mexist, fetch (through
    ``transport``), parse, then for every group the upload (the tables and
    payload concatenated into pinned staging buffers and copied without
    blocking, as ``finish_host_chunks`` does, timed to the copies' end), row
    11's fused decode and dequantization (the blob), the host C++ decode of
    the same group, the inject; then the suffix prefill over the injected
    slot."""
    ce = remote_tier(url, cfg, transport)
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
    for k in ("upload_ms", "decode_dequant_ms", "host_decode_ms",
              "inject_ms"):
        st[k] = 0.0
    up_bytes = 0
    dev = torch.device("cuda", torch.cuda.current_device())
    for g0 in range(0, STORE_CHUNKS, GROUP_CHUNKS):
        group = hcs[g0:g0 + GROUP_CHUNKS]
        c0 = group[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lens = np.concatenate([c.lens.reshape(-1) for c in group])
        cdf = cgs.staging((len(lens), 33), torch.int16, dev)
        np.concatenate([c.cdf.reshape(-1, 33) for c in group],
                       out=cdf.numpy().view(np.uint16))
        maxes = cgs.staging((len(group), *c0.maxes.shape), torch.float32,
                            dev)
        np.stack([c.maxes for c in group], out=maxes.numpy())
        payload = cgs.staging((sum(len(c.payload) for c in group),),
                              torch.uint8, dev)
        np.concatenate([np.frombuffer(c.payload, np.uint8) for c in group],
                       out=payload.numpy())
        offsets = cgs.staging((len(lens) + 1,), torch.int64, dev)
        offsets[0] = 0
        np.cumsum(lens, out=offsets.numpy()[1:])
        d_pay, d_offs, d_cdf, d_max = (cgs.upload(t, dev) for t in (
            payload, offsets, cdf, maxes))
        half = torch.from_numpy(np.stack([
            c0.key_bins.astype(np.int32) // 2 - 1,
            c0.value_bins.astype(np.int32) // 2 - 1]).astype(
                np.float32)).cuda()
        torch.cuda.synchronize()
        st["upload_ms"] += (time.perf_counter() - t0) * 1e3
        up_bytes += (payload.numel() + cdf.numel() * 2 + offsets.numel() * 8
                     + maxes.numel() * 4)
        t0 = time.perf_counter()
        blob = rd.decode_to_blob(
            d_pay, d_offs, d_cdf, d_max, half, nchunks=len(group), L=c0.L,
            H=c0.H, D=c0.D, T=c0.T, g=c0.g, N=c0.N, hf=False,
            dtype=cgs.torch_dtype(c0.dtype), tok_start=0,
            tok_stop=len(group) * c0.T)
        torch.cuda.synchronize()
        st["decode_dequant_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        range_coder.decode_streams(payload.numpy(), lens, c0.g * c0.T,
                                   cdf.numpy().view(np.uint16))
        st["host_decode_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        eng._inject(blob, 0, g0 * REMOTE_CHUNK)
        torch.cuda.synchronize()
        st["inject_ms"] += (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    llama.forward(params, cfg, tokens[:, CTX:],
                  torch.full((1,), CTX, dtype=torch.int32, device="cuda"),
                  eng._slot_view(0), last_logit_only=True)
    torch.cuda.synchronize()
    st["suffix_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  stages, {transport} transport (one pass each, ms; groups of 16 "
        f"summed): " + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in st.items())
        + f"; host -> device {up_bytes / 1e6:.3f} MB, pinned")
    st["host_to_device_bytes"] = up_bytes
    return st


@contextmanager
def counting_uploads():
    """Within the block, the host-to-device uploads of ``finish_host_chunks``
    (the grouped inject's tables and payloads), counted by whether their
    host buffer is pinned: a count the profiler cannot lose (late in a long
    run its windows drop records)."""
    seen, upload = Counter(pinned=0, pageable=0), cgs.upload

    def counted(host, device):
        seen["pinned" if host.is_pinned() else "pageable"] += 1
        return upload(host, device)

    cgs.upload = counted
    try:
        yield seen
    finally:
        cgs.upload = upload


def grouped_stream_overlap(eng, serve):
    """How much of the grouped inject's device work (each group's upload
    and fused decode, and its inject) runs while the host still fetches and
    parses later groups, in one ``serve()``d request: events recorded around
    each group's work on the one stream, placed on the host's clock by an
    event recorded on the idle card at the start. Returns the numbers and
    whether the card waited on the host with work it could overlap (the
    case for a second stream)."""
    marks, done = [], {}
    finish, inject, grouped = (eng._finish_group, eng._inject,
                               eng._grouped_stream)

    def timed(fn, kind):
        def call(*args):
            issue = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            marks.append((kind, issue, start, end))
            return out
        return call

    def grouped_and_mark(*args):
        out = grouped(*args)
        done["host"] = time.perf_counter()
        return out

    eng._finish_group = timed(finish, "decode")
    eng._inject = timed(inject, "inject")
    eng._grouped_stream = grouped_and_mark
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    try:
        serve()
    finally:
        eng._finish_group, eng._inject, eng._grouped_stream = (
            finish, inject, grouped)
    torch.cuda.synchronize()
    rows = [(kind, issue, t0 + e0.elapsed_time(s) / 1e3,
             t0 + e0.elapsed_time(e) / 1e3) for kind, issue, s, e in marks]
    t_host = done["host"]
    work = sum(e - s for _, _, s, e in rows)
    hidden = sum(max(0.0, min(e, t_host) - s) for _, _, s, e in rows)
    waited = sum(max(0.0, s - issue) for _, issue, s, _ in rows)
    tail = max(0.0, max(e for _, _, _, e in rows) - t_host)
    span = t_host - t0
    out = {"groups": sum(k == "decode" for k, *_ in rows),
           "host_stream_ms": span * 1e3, "device_work_ms": work * 1e3,
           "hidden_share": hidden / work if work else None,
           "queue_wait_ms": waited * 1e3, "tail_ms": tail * 1e3,
           "card_idle_share": 1 - work / span if span else None}
    # a second stream could overlap only group work that waited in the one
    # stream's queue or ran on after the host had issued the last group
    out["second_stream"] = (out["queue_wait_ms"] + out["tail_ms"]
                            > 0.05 * out["host_stream_ms"])
    log(f"  overlap of the grouped inject ({out['groups']} groups): the host "
        f"fetched, parsed and issued for {out['host_stream_ms']:.2f} ms; the "
        f"groups' device work (upload, fused decode, inject; the spans "
        f"between events around each call, so with the host's "
        f"concatenation inside them) {out['device_work_ms']:.3f} ms, of which "
        f"{100 * (out['hidden_share'] or 0):.1f} % ran before the host had "
        f"issued the last group and {out['tail_ms']:.3f} ms after; the work "
        f"waited {out['queue_wait_ms']:.3f} ms in the stream's queue; the "
        f"card idle at least {100 * (out['card_idle_share'] or 0):.1f} % "
        f"of the host's stream. Second stream for decode + inject: "
        + ("worth adding (group work waited in the queue or ran on after "
           "the host)" if out["second_stream"] else
           "not added (the card waits on the host's fetch and parse, not "
           "on queued work)"))
    return out


def phase_remote(cfg, params, ttft_full_ms, url):
    """Phase 9: reuse across engine instances through the cache server at
    ``url``. Returns (launch counts by sub-phase, the phase's numbers)."""
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
    launches["remote store"], out["store"] = remote_store(
        url, cfg, tokens_np, prefix)
    del cache, prefix
    gates, slot_kv = {}, {}
    for transport in TRANSPORTS:
        dense, slot, gates[transport] = remote_reuse_gate(
            url, cfg, params, tokens_np, full_logits, transport)
        slot_kv[transport] = dense.kv_pool[:, :, slot, :, :CTX]
        if transport != TRANSPORTS[-1]:
            dense.cache_engine.close()
            del dense
    same_kv = same_bits(*slot_kv.values())
    log(f"  the KV injected through the two transports is bit-equal: "
        f"{same_kv}")
    if not same_kv:
        raise SystemExit("remote reuse: the transports inject other KV")
    del slot_kv
    out["gate"] = gates["native"]
    out["gate_python"] = gates["python"]

    # timed: one engine as a user runs it (max_batch 1), each request a
    # new 512-token question on the stored document, per transport
    rng = np.random.default_rng(9)
    sp = SamplingParams(max_new_tokens=1)

    def question():
        return np.concatenate([tokens_np[:CTX], rng.integers(
            0, cfg.vocab_size, SUFFIX, dtype=np.int32)])

    out["transports"] = {}
    for transport in TRANSPORTS:
        b = remote_tier(url, cfg, transport, pipelined_backend=True)
        eng = ServingEngine(cfg, params, max_batch=1, max_seq=S + 8,
                            cache_engine=b)

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
        key = ("remote reuse" if transport == "native"
               else f"remote reuse {transport}")
        launches[key] = read_launch_counts()
        log(f"  TTFT remote, {transport} transport: {ttft[0]:.2f} ms "
            f"best of 3, median {ttft[1]:.2f} ms (each request a new "
            f"suffix); TTFT full {ttft_full_ms:.2f} ms (phase 3): ratio "
            f"{ttft_full_ms / ttft[0]:.3f}x; launches of the three "
            f"requests {launches[key]}")
        res = {"ttft_remote_ms": ttft[0], "ttft_remote_median_ms": ttft[1],
               "ttft_remote_all_ms": ttft}
        with counting_uploads() as uploads:
            res["profile"] = profile_window(
                f"remote reuse request, {transport} transport (fetch, "
                f"grouped decode + inject, suffix)",
                lambda: eng.generate([question()], sp), copies=True)
        groups = -(-STORE_CHUNKS // GROUP_CHUNKS)
        res["group_uploads"] = dict(uploads)
        log(f"  the profiled request's group uploads (counted where they "
            f"are issued): {dict(uploads)}, 5 a group for its {groups} "
            f"groups")
        if (uploads["pinned"] != 5 * groups or uploads["pageable"]
                or not res["profile"].get("h2d", {}).get("pinned")):
            raise SystemExit("remote reuse: the group uploads are not "
                             "all pinned")
        b.engine_.flush()
        res["overlap"] = grouped_stream_overlap(eng, serve)
        b.engine_.flush()
        b.close()
        del eng
        res["stages"] = remote_stage_split(url, cfg, params, tokens,
                                           tokens_np, transport)
        out["transports"][transport] = res
    native = out["transports"]["native"]
    out["ttft_remote_ms"] = native["ttft_remote_ms"]
    out["ttft_remote_median_ms"] = native["ttft_remote_median_ms"]
    out["ttft_full_ms"] = ttft_full_ms
    out["profile"], out["stages"] = native["profile"], native["stages"]

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
    same = torch.equal(pages, llama.cache_to_blob(dense.kv_pool, slot,
                                                  CTX))
    log(f"  paged: {n_pages} pages injected in groups; the first {CTX} "
        f"tokens of the pages equal the dense slot's KV: {same}; "
        f"launches {launches['remote paged']}")
    if not (same and r.cached_prefix_len >= CTX):
        raise SystemExit("remote paged wave: the pages differ from the "
                         "dense slot")
    dense.cache_engine.close()
    del dense, peng
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


def mla_bench(cfg, params):
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
    # one timed run each; the gate's runs above were the warm-up
    t_full = wall_best(lambda: prefill_full(), n=1, warm=False)
    t_reuse = wall_best(prefill_reuse, n=1, warm=False)
    log(f"  TTFT full {t_full:.2f} ms, TTFT reuse {t_reuse:.2f} ms, ratio "
        f"{t_full / t_reuse:.2f}x (one run after the gate's)")
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


def mla_remote(cfg, params, tokens_np, prefix, full_logits, kv_wire_bytes,
               url):
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
    kept = {}
    finish = eng._finish_prefill

    def finish_and_keep(req, logits):
        kept[req.request_id] = logits.float().clone()
        finish(req, logits)

    eng._finish_prefill = finish_and_keep
    with keeping_fused_decodes() as groups:
        t0 = time.perf_counter()
        [req] = eng.generate([tokens_np], SamplingParams(max_new_tokens=1))
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    b.engine_.flush()
    b.close()
    checks = fused_decodes_exact(groups)
    same_symbols = [c[0] for c in checks]
    same_blobs = [c[1] for c in checks]
    logits = kept[req.request_id]
    rel = ((logits - full_logits).norm() / full_logits.norm()).item()
    log(f"  store: {n} chunks in {store_ms:.2f} ms; wire {wire_bytes / 1e6:.3f}"
        f" MB for {raw / 1e6:.1f} MB of bf16 latents, compression "
        f"{raw / wire_bytes:.3f}x (phase 9's tinyllama K/V of the same "
        f"{CTX} tokens: {kv_wire_bytes / 1e6:.3f} MB); containers equal to "
        f"the host C++ coder's: {equal} of {len(wire)}")
    log(f"  served by a fresh pipelined engine in {serve_ms:.2f} ms: "
        f"cached_prefix_len {req.cached_prefix_len}; fused decode groups of "
        f"{[g[1].numel() - 1 for g in groups]} streams; symbols equal the "
        f"host C++ decode {same_symbols}; blobs equal those symbols "
        f"dequantized {same_blobs}")
    log(f"  first-token logits against the full prefill's (lossy; "
        f"reported): rel_l2 {rel:.4e}, top-1 {int(logits.argmax())} vs "
        f"{int(full_logits.argmax())}")
    if not (n == STORE_CHUNKS and equal == STORE_CHUNKS and groups
            and all(same_symbols) and all(same_blobs)
            and req.cached_prefix_len >= CTX - 1
            and bool(torch.isfinite(logits).all())):
        raise SystemExit("mla remote: a gate failed")
    return {"store_ms": store_ms, "wire_bytes": wire_bytes, "raw_bytes": raw,
            "compression": raw / wire_bytes, "kv_wire_bytes": kv_wire_bytes,
            "serve_ms": serve_ms, "cached_prefix_len": req.cached_prefix_len,
            "reuse_rel_l2": rel,
            "same_top1": int(logits.argmax()) == int(full_logits.argmax())}


def phase_mla(kv_wire_bytes, url):
    """Phase 10: DeepSeek-V2-Lite at full width and depth with random bf16
    weights, 10e through the cache server at ``url``. Returns (launch counts
    by sub-phase, the phase's numbers)."""
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
    out["bench"], tokens_np, full_logits, prefix = mla_bench(cfg, params)
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
                after_wave3=injected_equal_dense, near_tie=True,
                routing=routing, profile_prefill=True)
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
                               kv_wire_bytes, url)
    launches["mla remote"] = read_launch_counts()
    del prefix
    torch.cuda.empty_cache()
    blend_launches, out["blend"] = phase_blend(
        cfg, params, True, routing=routing,
        engines=[(MLAServingEngine, {}),
                 (MLAPagedServingEngine, {"page_size": PAGE,
                                          "num_pages": NP_BLEND})], reps=1)
    launches.update(blend_launches)
    decode_launches, out["decode_options"] = mla_decode_options(cfg, params)
    launches.update(decode_launches)
    del params
    torch.cuda.empty_cache()
    return launches, out


# ------------------------------------------ phase 14: the decode options ---

SPEC_K = 4  # proposals a verification forward checks: T = 5 a row
DECODE_NEW = 17  # tokens a request decodes: 1 at prefill, then 4 blocks of 4
DECODE_BLOCK = 4
DECODE_LOGPROBS = 5
DECODE_SEQ = 512  # max_seq of the phase's engines (4 slots)
MLA_DECODE_LAYERS = 3  # V2-Lite's depth here: its dense layer and two MoE
# the paged engines' arena: four slots of DECODE_SEQ + a verification's
# horizon, and spare pages
DECODE_PAGES = 4 * -(-(DECODE_SEQ + SPEC_K + 1) // PAGE) + 8


def decode_prompts(vocab):
    """Four prompts of four lengths, so that a verification forward runs
    T = 5 a row over rows of four kv_len: two repeat a motif (the n-gram
    proposer fires on them), two are random."""
    rng = np.random.default_rng(14)
    return [np.tile(rng.integers(0, vocab, 32, dtype=np.int32), 10),
            np.tile(rng.integers(0, vocab, 24, dtype=np.int32), 13)[:301],
            rng.integers(0, vocab, 257, dtype=np.int32),
            rng.integers(0, vocab, 211, dtype=np.int32)]


def witness_logits(cfg, params, seqs, kv_dtype="native"):
    """fp32 logits at every position of each sequence, from the plain
    witness: the forward with the kernels' plain attention (fp32 inside;
    over an int8 pool for ``kv_dtype="int8"``) and the LM head in fp32 (the
    engines round the final norm's output and the logits to bf16). A llama
    config runs ``llama.forward``, an MLA config ``mla.forward`` with
    ``latent_attention_reference`` bound as its attention."""
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = []
    if isinstance(cfg, mla.MLAConfig):
        def head32(x, params, cfg, last_logit_only):
            x32 = x.float()
            h = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                  + cfg.norm_eps)
            return (h * params["final_norm"].float()) @ params[
                "lm_head"].float()

        saved = mla.latent_flash_attention, mla._logits
        mla.latent_flash_attention = la.latent_attention_reference
        mla._logits = head32
        try:
            for s in seqs:
                toks = torch.as_tensor(np.asarray(s), device="cuda")
                logits, _ = mla.forward(
                    params, cfg, toks.long()[None], zero,
                    mla.new_latent_cache(cfg, 1, len(s)))
                out.append(logits[0])
        finally:
            mla.latent_flash_attention, mla._logits = saved
        return out
    return plain_first_logits(cfg, params, seqs, kv_dtype=kv_dtype,
                              every=True)


def _tie_steps(w, a, b):
    """How many bf16 steps, at the larger magnitude, the witness logits
    ``w`` put tokens ``a`` and ``b`` apart."""
    x, y = w[a], w[b]
    return ((x - y).abs() / _bf16_step(torch.maximum(x.abs(), y.abs()))
            ).item()


def tokens_agree(name, reqs, golden, prompts, witness):
    """Each request's tokens equal the sequential run's, or do up to a
    first differing token that the fp32 witness (its logits over the
    sequential run's sequence) puts near the sequential token: within
    TIE_STEPS bf16 steps (phase 5's rule, for two computations of the same
    shapes) or within TOP1_MARGIN of the witness logits' rms (phase 6d's
    rule for tokens computed in other shapes, which phase 10 applies too: a
    verification forward runs its projections over K + 1 rows a request
    and its attention through the kernels' body where a single step takes
    the key split, so its logits differ from a step's by more than the last
    rounding). Each gap is printed in both units."""
    ok, notes = True, []
    for i, (r, want) in enumerate(zip(reqs, golden)):
        got = r.output_tokens
        n = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if n is None:
            if len(got) != len(want):
                ok = False
                notes.append(f"request {i}: {len(got)} tokens, not "
                             f"{len(want)}")
            continue
        w = witness[i][len(prompts[i]) + n - 1]
        steps = _tie_steps(w, got[n], want[n])
        margin = ((w[got[n]] - w[want[n]]).abs()
                  / w.square().mean().sqrt()).item()
        tie = steps <= TIE_STEPS or margin <= TOP1_MARGIN
        ok &= tie
        notes.append(f"request {i}: token {n} differs ({got[n]} against "
                     f"{want[n]}); the fp32 witness puts them {steps:.4f} "
                     f"bf16 steps apart (at most {TIE_STEPS} for one "
                     f"shape), {margin:.4f} of its logits' rms (at most "
                     f"{TOP1_MARGIN} for other shapes): "
                     f"{'a near tie' if tie else 'not a near tie'}")
    log(f"  {name}: tokens equal the sequential run's "
        f"{'; '.join(notes) if notes else 'in every request'} "
        f"{'ok' if ok else 'FAILED'}")
    return ok


def logprobs_agree(name, reqs, prompts, witness, k=DECODE_LOGPROBS):
    """Every recorded logprob (the sampled token's and each of the top
    ``k``) within TOP1_MARGIN of the witness logits' rms of the witness's
    own log-softmax at that id, the ids distinct and in descending order,
    and the witness's best token among them."""
    worst, ok = 0.0, True
    for i, r in enumerate(reqs):
        for n, rec in enumerate(r.logprobs):
            w = witness[i][len(prompts[i]) + n - 1]
            lp = torch.log_softmax(w, dim=-1)
            tol = TOP1_MARGIN * w.square().mean().sqrt().item()
            ids = [t for t, _ in rec["top"]] + [rec["token"]]
            vals = [v for _, v in rec["top"]] + [rec["logprob"]]
            err = max(abs(v - lp[t].item()) for t, v in zip(ids, vals))
            worst = max(worst, err / tol)
            top = ids[:-1]
            ok &= (err <= tol and len(set(top)) == k
                   and vals[:-1] == sorted(vals[:-1], reverse=True)
                   and int(w.argmax()) in top)
    log(f"  {name}: logprobs of {sum(len(r.logprobs) for r in reqs)} "
        f"tokens and their top {k} against the fp32 witness: "
        f"largest error {worst:.3f} of the tolerance ({TOP1_MARGIN} of the "
        f"witness logits' rms) {'ok' if ok else 'FAILED'}")
    return ok, worst


def timed_decode(eng, prompts, sp):
    """Serve ``prompts``: the prefills first, then the decode calls alone,
    timed (each ends in the tokens' copy to the host). Returns (requests,
    decode tokens/s, host ms a call)."""
    reqs = [eng.add_request(Request(p, sp)) for p in prompts]
    while eng.waiting or eng.prefilling:
        eng.step()
    n0, calls = sum(len(r.output_tokens) for r in reqs), 0
    t0 = time.perf_counter()
    while eng.running:
        eng._decode_all()
        calls += 1
    secs = time.perf_counter() - t0
    toks = sum(len(r.output_tokens) for r in reqs) - n0
    return reqs, toks / secs, 1e3 * secs / calls


def count_syncs(fn):
    """(fn's result, the host syncs it issued): CUDA's synchronizing calls
    flagged by ``torch.cuda.set_sync_debug_mode``."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def decode_options(name, make, cfg, params, prompts, kv_dtype="native"):
    """One engine kind through the three options: sequential greedy with
    ``logprobs`` (the golden tokens, held to the fp32 witness), the same
    without logprobs timed at ``decode_block`` 1 and DECODE_BLOCK (tokens
    bit-equal; host syncs inside one block counted), ``spec_lookahead``
    SPEC_K with the n-gram proposer and with an oracle that proposes the
    golden continuation (tokens held to the golden ones by the tie rule).
    Returns (ok, the numbers)."""
    log(f"  -- {name}")
    res, ok = {}, True
    golden_reqs = make().generate(prompts, SamplingParams(
        max_new_tokens=DECODE_NEW, logprobs=DECODE_LOGPROBS))
    golden = [r.output_tokens for r in golden_reqs]
    with uncounted():
        witness = witness_logits(cfg, params, [
            np.concatenate([p, g[:-1]]) for p, g in zip(prompts, golden)],
            kv_dtype)
    lp_ok, res["logprob_worst_of_tol"] = logprobs_agree(
        f"{name}, logprobs={DECODE_LOGPROBS}", golden_reqs, prompts, witness)
    ok &= lp_ok

    sp = SamplingParams(max_new_tokens=DECODE_NEW)
    timed = {}
    for block in (1, DECODE_BLOCK):
        eng = make(decode_block=block)
        reqs, tok_s, call_ms = timed_decode(eng, prompts, sp)
        timed[block] = [r.output_tokens for r in reqs]
        # one more call of each, profiled (device time) and with its host
        # syncs counted, on two fresh requests brought to decode
        for p in prompts[:2]:
            eng.add_request(Request(p, SamplingParams(max_new_tokens=12)))
        while eng.waiting or eng.prefilling:
            eng.step()
        _, syncs = count_syncs(eng._decode_all)
        prof = profile_window(
            f"{name}, one decode call at decode_block {block} (2 of 4 rows "
            f"live)", eng._decode_all)
        eng.run()
        res[f"decode_block_{block}"] = {
            "tok_s": tok_s, "host_ms_per_call": call_ms,
            "host_ms_per_step": call_ms / block,
            "device_ms_per_step": (None if prof["device_ms"] is None
                                   else prof["device_ms"] / block),
            "syncs_per_call": syncs, "profile": prof}
        log(f"  {name}, decode_block {block}: {tok_s:.1f} tok/s, "
            f"{call_ms:.3f} ms a call of {block} step(s) (host), "
            f"{call_ms / block:.3f} ms a step; device "
            f"{res[f'decode_block_{block}']['device_ms_per_step']} ms a step "
            f"(profiled); host syncs in a call {syncs}")
        del eng
    same = timed[1] == timed[DECODE_BLOCK] == golden
    syncs = res[f"decode_block_{DECODE_BLOCK}"]["syncs_per_call"]
    log(f"  {name}: decode_block {DECODE_BLOCK} tokens bit-equal to "
        f"decode_block 1 and to the logprobs run: {same}; host syncs inside "
        f"a block: {syncs} (at most 1: the tokens' copy at its end) "
        f"{'ok' if same and syncs <= 1 else 'FAILED'}")
    ok &= same and syncs <= 1

    gold = {p.tobytes(): np.asarray(g, np.int32)
            for p, g in zip(prompts, golden)}
    lens = sorted({len(p) for p in prompts})

    def oracle(tokens, ngram, k):
        for n in lens:
            g = gold.get(np.asarray(tokens[:n], np.int32).tobytes())
            if g is not None and len(tokens) >= n:
                m = len(tokens) - n
                return g[m:m + k]
        return np.zeros(0, np.int32)

    for label, proposer in (("n-gram", None), ("oracle", oracle)):
        eng = make(spec_lookahead=SPEC_K)
        forwards = []
        spec_forward = eng._spec_forward
        eng._spec_forward = lambda inp, start: forwards.append(1) or (
            spec_forward(inp, start))
        saved = engine_mod._ngram_propose
        if proposer is not None:
            engine_mod._ngram_propose = proposer
        try:
            reqs = eng.generate(prompts, sp)
        finally:
            engine_mod._ngram_propose = saved
        prop = sum(r.spec_proposed for r in reqs)
        acc = sum(r.spec_accepted for r in reqs)
        log(f"  {name}, spec_lookahead {SPEC_K}, {label} proposer: "
            f"{len(forwards)} verification forwards for "
            f"{sum(len(r.output_tokens) - 1 for r in reqs)} decoded tokens; "
            f"proposed {prop}, accepted {acc}")
        ok &= tokens_agree(f"{name}, spec {label}", reqs, golden, prompts,
                           witness)
        if label == "oracle":
            ok &= acc > 0
        res[f"spec_{label}"] = {"forwards": len(forwards), "proposed": prop,
                                "accepted": acc}
        del eng
    return ok, res


def phase_decode_options(cfg, params):
    """Phase 14, tinyllama-1.1B at full depth: the dense native and int8
    engines and the paged bf16 and int8 engines. Returns (launch counts by
    engine, the numbers)."""
    prompts = decode_prompts(cfg.vocab_size)
    log(f"== phase 14: decode_block, spec_lookahead and logprobs, "
        f"tinyllama-1.1B, four requests of {[len(p) for p in prompts]} "
        f"tokens, {DECODE_NEW} new tokens each")
    kinds = [("dense native", ServingEngine, {}, "native"),
             ("dense int8", ServingEngine, {"kv_dtype": "int8"}, "int8"),
             ("paged bf16", PagedServingEngine,
              {"page_size": PAGE, "num_pages": DECODE_PAGES}, "native"),
             ("paged int8", PagedServingEngine,
              {"page_size": PAGE, "num_pages": DECODE_PAGES,
               "kv_dtype": "int8"}, "int8")]
    return decode_option_kinds(cfg, params, prompts, kinds, "tinyllama")


def decode_option_kinds(cfg, params, prompts, kinds, model):
    """:func:`decode_options` for each (name, engine class, options, pool
    dtype) of ``kinds``, each with the counts at 0 before it and read just
    after. Returns (launch counts by engine, the numbers); exits when a
    gate failed."""
    launches, out, ok = {}, {}, True
    for name, cls, kw, kv_dtype in kinds:
        def make(**opts):
            # every prompt prefilled in the first step, so that the
            # requests decode in step and a block holds no spent row
            return cls(cfg, params, max_batch=4, max_seq=DECODE_SEQ,
                       prefill_chunk=512, prefill_token_budget=4 * 512,
                       **kw, **opts)
        reset_launch_counts()
        k_ok, out[name] = decode_options(f"{model} {name}", make, cfg,
                                         params, prompts, kv_dtype)
        launches[f"decode options {model} {name}"] = read_launch_counts()
        ok &= k_ok
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"decode options, {model}: a gate failed")
    return launches, out


def mla_decode_options(cfg, params):
    """Phase 14 on DeepSeek-V2-Lite's weights at full width, cut to
    MLA_DECODE_LAYERS layers (views of phase 10's): the MLA dense and paged
    engines over native latents."""
    kd = cfg.first_k_dense_replace
    short = dataclasses.replace(cfg, n_layers=MLA_DECODE_LAYERS)
    sliced = dict(params)
    sliced["dense_layers"] = {k: v[:kd] for k, v in
                              params["dense_layers"].items()}
    sliced["moe_layers"] = {k: v[:MLA_DECODE_LAYERS - kd] for k, v in
                            params["moe_layers"].items()}
    prompts = decode_prompts(cfg.vocab_size)
    log(f"  -- 14b: DeepSeek-V2-Lite at full width, {MLA_DECODE_LAYERS} of "
        f"{cfg.n_layers} layers")
    kinds = [("MLA dense", MLAServingEngine, {}, "native"),
             ("MLA paged", MLAPagedServingEngine,
              {"page_size": PAGE, "num_pages": DECODE_PAGES}, "native")]
    return decode_option_kinds(short, sliced, prompts, kinds, "v2-lite")


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
    live blocks' mask for ``no_mask``, none for ``mxu_only``), by events
    back to back and queued behind a spin (``queued_ms``); then the split
    of the body's time, by queued times. Returns (launch counts, {kernel:
    rows}, {kernel: worst max abs error}, the phase's numbers)."""
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
    q_row1 = queued_ms(lambda: bench_mfu.row1(x), iters=5)
    q_sdpa = queued_ms(bench_mfu.sdpa_flash(x, G), iters=5)
    log(f"  row 1 flash_attention {t_row1:.4f} ms (queued {q_row1:.4f}), "
        f"SDPA (flash backend, K/V expanded over the heads) {t_sdpa:.4f} ms "
        f"(queued {q_sdpa:.4f})")
    queued, work = {}, {}
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
        queued[name] = queued_ms(lambda: bench_mfu.call(variant, x, bq, bk),
                                 iters=5)
        work[name] = flops
        plain_ms = cuda_ms(lambda: bench_mfu.plain(variant, x, bq, bk),
                           iters=1, warmup=1)
        library_ms, library = None, "none (no single call)"
        if name in bench_mfu.ROW1_FUNCTION:
            library_ms, library = t_sdpa, "SDPA flash"
        elif mode == "no_mask":
            library_ms = ablation_sdpa_live_blocks(x, G, bq, bk)
            library = "SDPA over the live blocks' mask"
        row = {"shape": name, "ms": ms, "queued_ms": queued[name],
               "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "flops": flops,
               "tflops": flops / ms / 1e9,
               "peak_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
               "row1_ms": t_row1, "sdpa_ms": t_sdpa,
               "max_abs_err_row1": row1_err}
        rows[kernel].append(row)
        log(f"  {kernel} | {name}: kernel {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, {100 * row['peak_share']:.2f} % "
            f"of peak), queued {queued[name]:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({bound_by}), plain {plain_ms:.4f} ms, library {library}"
            + (f" {library_ms:.4f} ms" if library_ms is not None else ""))
    del outs, x
    torch.cuda.empty_cache()
    split = ablation_split(queued, work, q_row1, geo["D"])
    return launches, rows, worst, dict(
        row1_ms=t_row1, sdpa_ms=t_sdpa, row1_queued_ms=q_row1,
        sdpa_queued_ms=q_sdpa, variants_queued_ms=queued, split=split)


def ablation_split(queued, work, row1_ms, D):
    """The Hopper body's time split by the variants' queued times: the
    softmax's share (``full`` - ``mxu_only``), the mask's (``full`` -
    ``no_mask`` with no_mask's time scaled to ``full``'s work: it computes
    every key of its live blocks), and what the overlap buys at equal tiles
    (``pair`` - ``pipelined``: both hold two score tiles, only
    ``pipelined`` issues the next tile's product before this tile's
    softmax); with ``full`` - ``pipelined``, which at D 128 also holds the
    two-tile schedules' 64-key tiles against ``full``'s 128, and ``full``
    against row 1."""
    full = queued["full"]
    bn_two = 128 if D == 64 else 64  # prefill_variants.cu, VariantGeometry
    split = {
        "softmax_ms": full - queued["mxu_only"],
        "mask_ms": full - queued["no_mask"] * work["full"] / work["no_mask"],
        "overlap_ms": queued["pair"] - queued["pipelined"],
        "full_minus_pipelined_ms": full - queued["pipelined"],
        "full_minus_pair_ms": full - queued["pair"],
        "tile_keys": {"full": 128, "pair": bn_two, "pipelined": bn_two},
        "full_over_row1": full / row1_ms,
    }
    log(f"  split of full's {full:.4f} ms (queued): softmax (full - "
        f"mxu_only) {split['softmax_ms']:.4f} ms, mask (full - no_mask x "
        f"{work['full'] / work['no_mask']:.4f} of its work) "
        f"{split['mask_ms']:.4f} ms, overlap at equal {bn_two}-key tiles "
        f"(pair - pipelined) {split['overlap_ms']:.4f} ms; full (128-key "
        f"tiles) - pipelined ({bn_two}) "
        f"{split['full_minus_pipelined_ms']:.4f} ms, full - pair ({bn_two}) "
        f"{split['full_minus_pair_ms']:.4f} ms; full / row 1 "
        f"{split['full_over_row1']:.4f}")
    return split


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


def phase_blend(cfg, params, mla_model, routing=None, engines=(), reps=3):
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
    same T (best of ``reps`` runs each), the tokens recomputed, a
    ``profile_window`` of one blend admission. Returns (launch counts by
    engine, the phase's numbers)."""
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

            times = [admit().ttft_s * 1e3 for _ in range(reps)]
            rec["ttft_best_ms"] = min(times)
            rec["ttft_full_ms"] = wall_best(prefill_full, n=reps, warm=False)
            rec["profile"] = profile_window(f"{name} blend admission", admit)
            log(f"  TTFT blend {rec['ttft_best_ms']:.2f} ms (best of {reps}) "
                f"vs "
                f"full prefill of {BLEND_T} tokens "
                f"{rec['ttft_full_ms']:.2f} ms: "
                f"{rec['ttft_full_ms'] / rec['ttft_best_ms']:.2f}x")
        out["engines"].append(rec)
        del eng
        torch.cuda.empty_cache()
    tier.close()
    return launches, out


# ---------------------------------------------------------------- phase 8 ---

# ------------------------ phase 13: the LlamaConfig families at full width ---

# the presets that the forwards refused before this slice, in the order
# phase 13a runs them
NEW_PRESETS = ("qwen3_4b", "qwen3_8b", "glm4_0414_9b", "olmo2_7b",
               "gemma2_9b", "gemma3_4b", "gpt_oss_20b", "mixtral_8x7b",
               "qwen3_moe_30b_a3b", "llama4_scout_17b_16e")
PRESET_PROMPT, PRESET_DECODE = 2048, 3
PRESET_NP = -(-(PRESET_PROMPT + PRESET_DECODE) // PAGE)
QWEN_MOE_MODEL = "qwen3-moe-30b-a3b"
GEMMA2_PROMPTS = (6000, 5987)


def preset_at_depth(name, n_layers=2):
    """The preset at full width and ``n_layers`` layers. Where its pattern
    puts no global layer among them (Gemma-3's 5 local to 1 global, Llama-4's
    3 to 1), the last of them is made global, so that both kinds run."""
    cfg = getattr(llama.LlamaConfig, name)()
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.sliding_window is not None and not cut.layer_windows().any():
        cut = dataclasses.replace(
            cut, global_layer_map=(False,) * (n_layers - 1) + (True,))
    return cut


def expected_kinds(cfg, phase):
    """The launch-count keys a forward of ``cfg`` gives the attention
    kernels in ``phase`` ("prefill" or "decode"): "+window" on local
    layers, "+softcap" and "+sinks" where the config has them."""
    marks = ("+softcap" if cfg.attn_logit_softcap else "") + (
        "+sinks" if cfg.attn_sinks else "")
    return tuple(sorted({phase + ("+window" if w else "") + marks
                         for w in llama._layer_windows(cfg)}))


def preset_paths(cfg):
    """(name, fresh pool or arena, forward, extra arguments) of the four
    paths a preset runs in phase 13a: the dense native and int8 pools and
    the bf16 and int8 arenas (page 64, one sequence's table)."""
    S = PRESET_NP * PAGE
    table = torch.arange(1, PRESET_NP + 1, dtype=torch.int32,
                         device="cuda")[None]
    return [
        ("dense native", lambda: llama.new_kv_cache(cfg, 1, S),
         llama.forward, ()),
        ("dense int8", lambda: llama.new_quantized_kv_cache(cfg, 1, S),
         llama.forward_quantized, ()),
        ("paged bf16",
         lambda: paged.new_paged_kv_pool(cfg, PRESET_NP + 1, PAGE),
         paged.forward_paged, (table,)),
        ("paged int8",
         lambda: paged.new_quantized_paged_pool(cfg, PRESET_NP + 1, PAGE),
         paged.forward_paged_quantized, (table,)),
    ]


def _clone_pool(pool):
    return ({k: v.clone() for k, v in pool.items()} if isinstance(pool, dict)
            else pool.clone())


def phase_presets():
    """Phase 13a: every newly served preset at full width and 2 layers with
    random bf16 weights: a 2048-token prompt and 3 decode steps through the
    dense native and int8 pools and the bf16 and int8 arenas; the prompt's
    last-token logits and the last decode step's held against the same
    forward with the plain attention on a copy of the same pool (an MoE
    preset's plain forward routed as the kernel forward was, the (layer,
    token) sets it would have picked otherwise counted). Returns (launch
    counts by preset, the phase's numbers)."""
    log(f"== phase 13a: the newly served presets at full width and 2 layers, "
        f"a {PRESET_PROMPT}-token prompt and {PRESET_DECODE} decode steps "
        f"over the dense native and int8 pools and the bf16 and int8 arenas")
    launches, out = {}, {}
    rng = np.random.default_rng(13)
    for name in NEW_PRESETS:
        cfg = preset_at_depth(name)
        log(f"  -- {name}: dim {cfg.dim}, heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads}, D {cfg.head_dim}, global layers "
            f"{cfg.layer_windows().tolist()}, "
            f"{cfg.n_experts or 0} experts")
        params = draw_params(cfg)
        routing = Routing(model="llama") if cfg.n_experts else None
        tokens = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, PRESET_PROMPT),
            device="cuda").long()[None]
        reset_launch_counts()
        rows = {}
        for path, new, fwd, extra in preset_paths(cfg):
            def step(tok, pos, pool, use_kernel=True):
                logits, _ = fwd(params, cfg, tok, torch.tensor(
                    [pos], dtype=torch.int32, device="cuda"), pool, *extra,
                    use_kernel=use_kernel, last_logit_only=True)
                return logits[0, -1].float()

            def against_plain(tok, pos, pool):
                """The kernel step on ``pool``, the plain step on a copy of
                it as it was: (kernel logits, plain logits, swaps)."""
                copy = _clone_pool(pool)
                if routing is None:
                    got = step(tok, pos, pool)
                    return got, step(tok, pos, copy, False), 0
                with routing:
                    got, picks = routed(routing, lambda: step(tok, pos, pool))
                    routing.swapped = 0
                    want, _ = routed(routing,
                                     lambda: step(tok, pos, copy, False),
                                     force=picks)
                return got, want, routing.swapped

            pool = new()
            got, want, sw1 = against_plain(tokens, 0, pool)
            pos, nxt = PRESET_PROMPT, int(got.argmax())
            for _ in range(PRESET_DECODE - 1):
                logits = step(torch.tensor([[nxt]], device="cuda"), pos, pool)
                pos, nxt = pos + 1, int(logits.argmax())
            got2, want2, sw2 = against_plain(
                torch.tensor([[nxt]], device="cuda"), pos, pool)
            ok = all(bool(torch.isfinite(t).all()) for t in (got, got2))
            ok = _logits_agree(f"{path}: prompt's last token and the last "
                               f"decode step vs the plain attention"
                               f"{f' (routed as the kernel forward: {sw1} and {sw2} sets swapped)' if routing else ''}",
                               [got, got2], [want, want2],
                               near_tie=True) and ok
            rows[path] = {"rel_l2": [((g - w).norm() / w.norm()).item()
                                     for g, w in ((got, want),
                                                  (got2, want2))],
                          "swapped": [sw1, sw2]}
            if not ok:
                raise SystemExit(f"{name} {path}: the kernel path disagrees "
                                 f"with the plain attention")
            del pool
        launches[f"preset {name}"] = read_launch_counts()
        out[name] = rows
        del params
        torch.cuda.empty_cache()
    return launches, out


@contextmanager
def moe_meter():
    """While entered, the device time of every ``llama._moe_mlp`` call
    (routing, dispatch, expert products and combine; CUDA events around
    each) and the rows of the padded expert blocks against the routed
    pairs (``experts.dispatch``). Yields a dict whose "ms", "calls",
    "block_rows" and "pairs" are read after a synchronise."""
    stats = {"events": [], "block_rows": 0, "pairs": 0}
    moe, dispatch = llama._moe_mlp, experts.dispatch

    def timed_moe(h, lp, cfg, *tp):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = moe(h, lp, cfg, *tp)
        end.record()
        stats["events"].append((start, end))
        return y

    def counted_dispatch(hf, topi, n_experts, scale=None):
        x, slot = dispatch(hf, topi, n_experts, scale)
        stats["block_rows"] += x.shape[0] * x.shape[1]
        stats["pairs"] += topi.numel()
        return x, slot

    llama._moe_mlp, experts.dispatch = timed_moe, counted_dispatch
    try:
        yield stats
    finally:
        llama._moe_mlp, experts.dispatch = moe, dispatch
        torch.cuda.synchronize()
        stats["ms"] = sum(a.elapsed_time(b) for a, b in stats.pop("events"))


def llama_bench(cfg, params, routing, model):
    """13b's bench shape: full prefill of CTX + SUFFIX tokens, store of the
    CTX prefix into the "cuda" tier, retrieve, inject, suffix prefill. The
    suffix's expert choices in the reuse request are compared with the full
    prefill's: a request whose routing flipped in some (layer, token) is
    held to ``REL_L2_MOE`` and run again routed as the full prefill, which
    must hold ``REL_L2_REUSE``; else it is held to ``REL_L2_REUSE``. Phase
    6d's top-1 rule. TTFT full and reuse with the MoE MLP's device time
    and padded rows over each (one run each after the gate's), and a
    profiler window over the reuse request."""
    log(f"  -- 13b bench: prefill -> store -> retrieve -> inject -> suffix "
        f"prefill, CTX {CTX} + SUFFIX {SUFFIX}")
    S = CTX + SUFFIX
    tokens_np = np.random.default_rng(14).integers(0, cfg.vocab_size, S,
                                                   dtype=np.int32)
    tokens = torch.as_tensor(tokens_np, device="cuda").long()[None]
    engine = _tier(model, cfg)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefill_full():
        logits, cache = llama.forward(params, cfg, tokens, zero,
                                      llama.new_kv_cache(cfg, 1, S),
                                      last_logit_only=True)
        return logits[0, -1].float(), cache

    def prefill_reuse():
        blob, mask = engine.retrieve(tokens_np, return_tuple=False)
        if int(mask.sum()) != CTX:
            raise SystemExit(f"expected {CTX} hits, got {int(mask.sum())}")
        cache = llama.blob_into_cache(llama.new_kv_cache(cfg, 1, S), blob)
        logits, _ = llama.forward(
            params, cfg, tokens[:, CTX:],
            torch.full((1,), CTX, dtype=torch.int32, device="cuda"), cache,
            last_logit_only=True)
        return logits[0, -1].float()

    with routing:
        (full_logits, cache), full_picks = routed(routing, prefill_full)
        n_chunks = engine.store(tokens_np[:CTX],
                                llama.cache_to_blob(cache, 0, CTX))
        del cache
        reuse_logits, reuse_picks = routed(routing, prefill_reuse)
        want = full_picks[:, CTX:]
        flips = int((reuse_picks != want).any(dim=-1).sum())
        seen = want.shape[0] * want.shape[1]
        log(f"  stored {n_chunks} chunks; the suffix's routing in the reuse "
            f"request differs from the full prefill's in {flips} of {seen} "
            f"(layer, token) top-{cfg.n_experts_per_tok} sets")
        ok = bool(torch.isfinite(reuse_logits).all()) and _logits_agree(
            "reuse vs full prefill", [reuse_logits], [full_logits],
            near_tie=True, flips=[(flips, seen)])
        if ok and flips:
            routing.swapped = 0
            forced, _ = routed(routing, prefill_reuse, force=want)
            log(f"  reuse again routed as the full prefill: "
                f"{routing.swapped} sets replaced")
            ok = _logits_agree("reuse routed as the full prefill vs full "
                               "prefill", [forced], [full_logits],
                               near_tie=True)
        del full_picks, reuse_picks, want
    if not ok:
        raise SystemExit(f"{model}: reuse logits disagree with the full "
                         f"prefill")
    meters = []
    for name, fn in (("full prefill", lambda: prefill_full()),
                     ("reuse request", prefill_reuse)):
        with moe_meter() as meter:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        log(f"  {name}: MoE MLP device time {meter['ms']:.2f} ms of "
            f"{wall:.2f} ms wall ({meter['ms'] / wall:.4f}); padded expert "
            f"blocks {meter['block_rows']} rows for {meter['pairs']} routed "
            f"pairs ({meter['block_rows'] / meter['pairs']:.4f}x)")
        meters.append({"window": name, "wall_ms": wall, "moe_ms": meter["ms"],
                       "block_rows": meter["block_rows"],
                       "pairs": meter["pairs"]})
    # the metered runs are the timed ones (the gate's were the warm-up):
    # their CUDA events add no wait
    t_full, t_reuse = meters[0]["wall_ms"], meters[1]["wall_ms"]
    log(f"  TTFT full {t_full:.2f} ms, TTFT reuse {t_reuse:.2f} ms, ratio "
        f"{t_full / t_reuse:.2f}x (the metered runs, after the gate's)")
    profile = [profile_window(f"{model} reuse request", prefill_reuse,
                              top=8)]
    engine.close()
    return {"ttft_full_ms": t_full, "ttft_reuse_ms": t_reuse,
            "speedup": t_full / t_reuse, "routing_flips": [flips, seen],
            "moe": meters, "profile": profile}


def phase_qwen3_moe():
    """Phase 13b: Qwen3-30B-A3B at full width and depth (48 layers, 128
    experts, top 8, qk-norm; random bf16 weights from a seeded generator,
    61 GB): the bench shape (:func:`llama_bench`), phase 4's four waves on
    ``ServingEngine`` over the native and the int8 pool and phase 5's on
    ``PagedServingEngine`` over the bf16 and the int8 arena (one
    preemption), with a profiled decode step each, the expert choices
    counted by :class:`Routing` as phase 10 counts V2-Lite's. Returns
    (launch counts by sub-phase, the phase's numbers)."""
    cfg = llama.LlamaConfig.qwen3_moe_30b_a3b()
    log(f"== phase 13b: Qwen3-30B-A3B ({cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, D {cfg.head_dim}, "
        f"{cfg.n_experts} experts of {cfg.moe_hidden_dim}, top "
        f"{cfg.n_experts_per_tok}), random weights, full width and depth")
    params = draw_params(cfg)
    launches, out = {}, {}
    routing = Routing(model="llama")
    reset_launch_counts()
    out["bench"] = llama_bench(cfg, params, routing, QWEN_MOE_MODEL)
    launches["qwen3-moe bench"] = read_launch_counts()
    first = {}
    for kv_dtype in ("native", "int8"):
        reset_launch_counts()
        with routing:
            prompts, first[kv_dtype] = phase_serving(
                cfg, params, kv_dtype, model=QWEN_MOE_MODEL, max_new=8,
                near_tie=True, routing=routing,
                label=f"  -- 13b: ServingEngine, four waves, {kv_dtype} pool")
        launches[f"qwen3-moe serving {kv_dtype}"] = read_launch_counts()
        torch.cuda.empty_cache()
    if not _logits_agree("int8 pool vs native pool, wave 1", first["int8"],
                         first["native"], REL_L2_INT8, same_top1=False):
        raise SystemExit("qwen3-moe: the int8 pool's logits left the native "
                         "pool's")
    out["dense_decode_profile"] = profile_dense_decode_step(
        cfg, params, prompts, "native")
    log("  -- 13b: PagedServingEngine (page 64), four waves per arena")
    paged_first, out["paged_decode_profiles"] = {}, []
    for kv_dtype, arena in (("native", "bf16"), ("int8", "int8")):
        reset_launch_counts()
        with routing:
            paged_first[arena], profile = paged_tinyllama_waves(
                cfg, params, prompts, first["native"], kv_dtype,
                model=QWEN_MOE_MODEL, max_new=8, near_tie=True,
                routing=routing)
        launches[f"qwen3-moe paged {arena}"] = read_launch_counts()
        out["paged_decode_profiles"].append(profile)
        torch.cuda.empty_cache()
    if not _logits_agree("int8 arena vs bf16 arena, wave 1",
                         paged_first["int8"], paged_first["bf16"],
                         REL_L2_INT8, same_top1=False):
        raise SystemExit("qwen3-moe: the int8 arena's logits left the bf16 "
                         "arena's")
    del params
    torch.cuda.empty_cache()
    return launches, out


def phase_gemma2():
    """Phase 13c: Gemma-2-9B at full width and depth (42 layers, D 256,
    softcap 50, window 4096 on alternate layers) on ``PagedServingEngine``,
    two prompts past the window, bf16 then int8 arena, held as phase 6
    holds Phi-3 (phase 6d's top-1 rule)."""
    log("== phase 13c: PagedServingEngine, Gemma-2-9B (42 layers, D 256, "
        "softcap 50, window 4096 on alternate layers), full width and depth")
    cfg = llama.LlamaConfig.gemma2_9b()
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in GEMMA2_PROMPTS]
    return paged_full_depth(cfg, draw_params(cfg), "gemma2", prompts, 200,
                            near_tie=True)


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


def event_span_ms(fn):
    """(ms from an event recorded before ``fn``'s first launch to one
    recorded after its last, host ms of the call to its synchronize), one
    warm call on an idle card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def queued_ms(fn, iters, flush=None):
    """Mean device time of one call of ``fn`` in ms, each of ``iters``
    calls between its own two events, all of them queued while the card
    spins (``torch.cuda._sleep``), so that no call waits for the host:
    what the card takes for the call's kernels alone. With ``flush`` (a
    buffer), the L2 cache is flushed before each call, outside its events.
    The spin doubles until the card is still in it when the host has
    queued the last call."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    spin = 1 << 24  # cycles, about 10 ms
    for _ in range(8):
        torch.cuda._sleep(spin)
        for start, end in events:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        queued = not events[0][0].query()
        torch.cuda.synchronize()
        if queued:
            return sum(s.elapsed_time(e) for s, e in events) / iters
        spin *= 2
    raise SystemExit("queued_ms: the host did not queue the calls within "
                     "the card's spin")


def time_paged(case, gen, flush):
    """Phase 8's row of a paged case: its times by events (back to back, and
    with the L2 cache flushed before each launch), the kernels alone (by
    the profiler, and queued behind a spin, warm and with the L2 cache
    ``flush``ed), its bound, plain version and library call."""
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
           "plain_ms": plain_ms,
           "library_ms": (None if sdpa_ms is None
                          else gather_ms + sdpa_ms),
           "library_gather_ms": gather_ms, "library_sdpa_ms": sdpa_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    # the kernels alone, without the gaps in which the card waits for
    # the host (rows 4 and 6 at decode: the split and the combine): by
    # the profiler, and by events around calls queued behind a spin,
    # warm and with the L2 cache flushed before each call
    row["kernel_ms"] = kernel_ms(lambda: entry(*args, **kw), iters=50)
    row["queued_ms"] = queued_ms(lambda: entry(*args, **kw), iters=50)
    row["queued_cold_ms"] = queued_ms(lambda: entry(*args, **kw),
                                      iters=50, flush=flush)
    dev = (f" (L2 flushed before each launch: {cold_ms:.4f} ms; the "
           f"kernels alone: profiler {row['kernel_ms']}, queued "
           f"{row['queued_ms']:.4f} ms, queued with the L2 flushed "
           f"{row['queued_cold_ms']:.4f} ms)")
    lib = ("none (no single call)" if sdpa_ms is None else
           f"gather {gather_ms:.4f} ms + SDPA {sdpa_ms:.4f} ms")
    log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms{dev}, "
        f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
        f"library {lib}")
    return row


def phase_yardstick():
    """{kernel: rows}, one row per shape."""
    log("== phase 8: kernel time vs bound, plain version and library calls")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {name: [] for name in KERNELS}

    def time_attention(case, gen):
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
        # the kernels alone: events around calls queued behind a spin
        row["queued_ms"] = queued_ms(lambda: ops.flash_attention(
            q, k, v, qo, kl, kv_head_major=True), iters=50 if decode else 10)
        extra = f" (queued {row['queued_ms']:.4f} ms)"
        if decode:
            # the split decode's two kernels alone, and SDPA's
            row["kernel_ms"] = kernel_ms(lambda: ops.flash_attention(
                q, k, v, qo, kl, kv_head_major=True), iters=50)
            row["library_kernel_ms"] = kernel_ms(
                lambda: sdpa(qh, k, v, enable_gqa=True, **mask_kw), iters=50)
            extra += (f" (device time of the kernels alone: "
                      f"{row['kernel_ms']} ms, SDPA's "
                      f"{row['library_kernel_ms']} ms)")
        log(f"  flash_attention | {name}: kernel {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, SDPA "
            f"{library_ms:.4f} ms{extra}")
        rows["flash_attention"].append(row)

    for case in attention_cases():
        time_attention(case, gen)

    def time_combine(name, paged, part_o, part_ml, T, G):
        ms = cuda_ms(lambda: attn.combine_partials(part_o, part_ml, T, G),
                     iters=200)
        plain_ms = cuda_ms(lambda: attn.combine_partials_reference(
            part_o, part_ml, T, G), iters=20)
        bound_ms, bound_by = combine_bound(part_o, part_ml, T, G)
        row = {"shape": name, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "queued_ms": queued_ms(lambda: attn.combine_partials(
                   part_o, part_ml, T, G), iters=50)}
        dev = f" (queued {row['queued_ms']:.4f} ms)"
        if paged:
            # the paged split decode's combine alone, without the gaps in
            # which the card waits for the host
            row["kernel_ms"] = kernel_ms(lambda: attn.combine_partials(
                part_o, part_ml, T, G), iters=50)
            dev += f" (device time {row['kernel_ms']})"
        rows["combine_partials"].append(row)
        log(f"  combine_partials | {name}: kernel {ms:.4f} ms{dev}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"library none (no single call)")

    for case in combine_cases():
        time_combine(case[0], False, *make_combine_inputs(case, gen))

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
        row["queued_ms"] = queued_ms(
            lambda: dense_call(case, q, kv, qo, kl, kw),
            iters=50 if case["T"] == 1 else 10)
        if case["T"] == 1:
            # the split decode's two kernels alone, without the gaps in
            # which the card waits for the host
            row["kernel_ms"] = kernel_ms(
                lambda: dense_call(case, q, kv, qo, kl, kw), iters=50)
        lib = ("none" if sdpa_ms is None else
               (f"dequantize {deq_ms:.4f} ms + " if deq_ms is not None
                else "") + f"SDPA {sdpa_ms:.4f} ms")
        extra = (f", flash_attention {row['flash_attention_ms']:.4f} ms, "
                 f"again {row['ms_again']:.4f} ms"
                 if "ms_again" in row else "")
        extra += f" (queued {row['queued_ms']:.4f} ms)"
        if "kernel_ms" in row:
            extra += f" (device time of the kernels alone {row['kernel_ms']})"
        log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms"
            f"{extra}, bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms, library {lib}")
        rows[case["kernel"]].append(row)
        del q, kv

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for case in paged_cases():
        rows[case["kernel"]].append(time_paged(case, gen, flush))
    # after the paged kernels, as in phase 2
    for case in paged_combine_cases():
        time_combine(case["name"], True, *make_paged_combine_inputs(case, gen))
    skip_former_coder_draws(gen)
    rows.update(coder_yardstick(sm_clock_hz()))

    def time_latent(case, gen):
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
        row["queued_ms"] = queued_ms(lambda: entry(*args, **kw),
                                     iters=50 if decode else 5)
        if decode:
            # the kernels alone (row 10: the split and the combine)
            row["kernel_ms"] = kernel_ms(lambda: entry(*args, **kw),
                                         iters=50)
        prep = ("gather" if case["paged"] else "dequantize")
        lib = (f"{prep} {pre_ms:.4f} ms + " if pre_ms is not None else "") + (
            f"SDPA {sdpa_ms:.4f} ms (backends that take it: "
            f"{', '.join(backends)})")
        dev = f" (queued {row['queued_ms']:.4f} ms)" + (
            f" (device time {row['kernel_ms']})" if "kernel_ms" in row
            else "")
        log(f"  {case['kernel']} | {case['name']}: kernel {ms:.4f} ms{dev}, "
            f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"library {lib}")
        rows[case["kernel"]].append(row)

    for case in latent_cases():
        time_latent(case, gen)

    for case in latent_combine_cases():
        part_o, part_ml, T, H = make_latent_combine_inputs(case, gen)
        ms = cuda_ms(lambda: pla.combine_partials(part_o, part_ml, T, H),
                     iters=200)
        dev_ms = kernel_ms(lambda: pla.combine_partials(part_o, part_ml, T,
                                                        H), iters=50)
        q_ms = queued_ms(lambda: pla.combine_partials(part_o, part_ml, T, H),
                         iters=50)
        plain_ms = cuda_ms(lambda: pla.combine_partials_reference(
            part_o, part_ml, T, H), iters=20)
        bound_ms, bound_by = combine_bound(part_o[:, None], part_ml[:, None],
                                           T, H)
        rows["latent_combine_partials"].append({
            "shape": case["name"], "ms": ms, "kernel_ms": dev_ms,
            "queued_ms": q_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  latent_combine_partials | {case['name']}: kernel {ms:.4f} ms "
            f"(device time {dev_ms}, queued {q_ms:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"library none (no single call)")
        del part_o, part_ml
    opt_gen = torch.Generator(device="cuda").manual_seed(13)
    for case in paged_option_cases():
        rows[case["kernel"]].append(time_paged(case, opt_gen, flush))
    ver_gen = torch.Generator(device="cuda").manual_seed(14)
    for family, case in verify_cases():
        if family == "paged":
            rows[case["kernel"]].append(time_paged(case, ver_gen, flush))
            continue
        kernel, call, plain, library, (bound_ms, bound_by) = verify_call(
            family, case, ver_gen)
        row = {"shape": case["name"], "ms": cuda_ms(call, iters=200),
               "cold_ms": cuda_ms_cold(call, iters=50),
               "plain_ms": cuda_ms(plain, iters=3, warmup=1),
               "library_ms": library(200), "bound_ms": bound_ms,
               "bound_by": bound_by,
               "queued_ms": queued_ms(call, iters=50),
               "queued_cold_ms": queued_ms(call, iters=50, flush=flush)}
        lib = ("none (no single call)" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        log(f"  {kernel} | {case['name']}: kernel {row['ms']:.4f} ms (L2 "
            f"flushed before each launch: {row['cold_ms']:.4f} ms; the "
            f"kernels alone, queued {row['queued_ms']:.4f} ms, queued with "
            f"the L2 flushed {row['queued_cold_ms']:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {row['plain_ms']:.4f} "
            f"ms, library {lib}")
        rows[kernel].append(row)
        del call, plain, library
    # phase 15's shapes of rows 1 and 8, drawn as in phase 2
    quality_gen = torch.Generator(device="cuda").manual_seed(16)
    for case in quality_attention_cases():
        time_attention(case, quality_gen)
    for case in quality_latent_cases():
        time_latent(case, quality_gen)
    return rows


def paged_library(case, args, iters):
    """No single PyTorch call reads a paged arena: the library yardstick is
    the gather of the live pages into dense bf16 K/V [B, H_kv, S, D]
    (dequantized for an int8 arena), then SDPA over it with the same mask.
    Returns (gather ms, SDPA ms), or (None, None) where a softcap or sinks
    leave no single call."""
    if case["softcap"] or case["sinks"]:
        return None, None
    if case["quant"]:
        q, k_pool, v_pool, k_scale, v_scale, table, qo, kl = args
    else:
        q, k_pool, v_pool, table, qo, kl = args
        k_scale = v_scale = None
    B, T, Hkv, D = case["B"], case["T"], case["Hkv"], case["D"]
    page = case["page"]
    n_live = -(-max(case["kv_len"]) // page)
    ids = table[:, :n_live].long()
    S = n_live * page

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
    W = case["window"]
    if W and case["kind"] == "chunked":
        mask &= (kpos // W) == (qpos // W)
    elif W:
        mask &= kpos > qpos - W
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (cuda_ms(gather, iters=iters),
            cuda_ms(lambda: sdpa(qh, k, v, attn_mask=mask, enable_gqa=True,
                                 scale=case["sm_scale"]),
                    iters=iters))


# --------------------------------------------------------------- phase 15 ---

def gate_line(r, ratio):
    return (f"compression {r[ratio]}x, KL {r['logit_kl']}, top-1 "
            f"{r['top1_agreement']}, confident top-1 "
            f"{r['confident_top1_agreement']}, ppl exact {r['ppl_exact']} "
            f"codec {r['ppl_codec']} delta {r['ppl_delta']}; pass "
            f"{r['pass']}")


def quality_codec_exact(dev):
    """The trained dense model's exact context blob through rows 12 and 11
    against the host C++ coder: the containers must be byte-equal and the
    decoded blobs bit-equal (trained KV's symbol statistics differ from
    random KV's)."""
    cfg = quality_common.quality_config("bfloat16")
    params = quality_common.load_params(cfg, device=dev)
    tokens = quality_common.make_eval_tokens(
        np.random.default_rng(0), QUALITY_CTX + QUALITY_CONT)
    with uncounted():
        blob = eval_quality.context_blob(llama, cfg, params, tokens,
                                         QUALITY_CTX, dev)
        name = "lmcache-tpu/quality-8l"
        card = eval_quality.codec_round_trip(blob, name, dev)
        host = eval_quality.codec_round_trip(blob, name, dev, coder="off")
        torch.cuda.synchronize()
    return card[0] == host[0] and same_bits(card[1], host[1])


def phase_quality():
    """Phase 15: the codec quality gate of ``tools/eval_quality.py`` on the
    in-repo trained checkpoints, through the port's eval tool on the card in
    bf16; the dense sweep's 4-bin row must exceed the default row's KL and
    its 2-bin row (whose KL is NaN) the default row's perplexity delta.
    Returns (launch counts, the numbers)."""
    log(f"== phase 15: codec quality gate, the trained checkpoints, ctx "
        f"{QUALITY_CTX} + cont {QUALITY_CONT}, bf16")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    reset_launch_counts()
    dense = eval_quality.evaluate("trained", QUALITY_CTX, QUALITY_CONT)
    latent = eval_quality.evaluate_mla(QUALITY_CTX, QUALITY_CONT,
                                       trained=True)
    rows = eval_quality.sweep("trained", QUALITY_CTX, QUALITY_CONT, 0)
    launches = {"quality gate": read_launch_counts()}
    gate_s = time.perf_counter() - t0
    log(f"  dense (D 64, G 2): {gate_line(dense, 'compression_x')}")
    log(f"  MLA (latent {latent['latent_dim']}, against bf16 latents): "
        f"{gate_line(latent, 'compression_vs_bf16_x')}")
    log(f"  sweep, dense (bins: compression, KL, ppl delta): " + "; ".join(
        f"{r['bins']}: {r['compression_x']}x, {r['logit_kl']}, "
        f"{r['ppl_delta']}" for r in rows))
    exact = quality_codec_exact(dev)
    log(f"  rows 12 and 11 on the trained dense blob: containers and decoded "
        f"blob equal to the host C++ coder's: {exact}; the gate and the sweep "
        f"{gate_s:.1f} s; launches {launches['quality gate']}")
    for r in (dense, latent):
        if not (r["pass"] and r["logit_kl"] <= eval_quality.KL_GATE
                and r["confident_top1_agreement"]
                >= eval_quality.CONFIDENT_TOP1_GATE
                and r["ppl_delta"] < eval_quality.PPL_DELTA_GATE):
            raise SystemExit(f"quality gate: {r['model']} fails")
    # at 2 bins the quantizer's half step (bins // 2 - 1) is 0 and the
    # dequantization (s - half) * max / half gives 0 / 0 in both packages:
    # the decoded cache is NaN, its KL NaN and its perplexity the capped
    # exp(700). So the 2-bin row is held by its perplexity delta, and the
    # KL check is carried by the 4-bin row, the fewest bins with a finite KL
    if not (rows[-2]["logit_kl"] > rows[0]["logit_kl"]
            and rows[-1]["ppl_delta"] > rows[0]["ppl_delta"]):
        raise SystemExit("quality gate: fewer bins do not move the KL and "
                         "the perplexity past the default schedule's")
    if not exact:
        raise SystemExit("quality gate: the coder kernels differ from the "
                         "host coder on trained KV")
    # strict JSON has no NaN: the 2-bin row's KL is written as null
    rows = [{k: None if isinstance(v, float) and v != v else v
             for k, v in r.items()} for r in rows]
    return launches, {"dense": dense, "mla": latent, "sweep": rows,
                      "coders_exact": exact, "seconds": gate_s}


# --------------------------------------------------------------- phase 16 ---

TIER_MODEL = "tinyllama-1.1b-tiers"


def tier_engine(cfg, params, tier_cfg, **meta):
    """A ``ServingEngine`` (max_batch 1) over a cache engine of
    ``tier_cfg`` that keeps each request's first-token logits."""
    tier = LMCacheEngine(tier_cfg, LMCacheEngineMetadata(
        model_name=meta.get("model_name", TIER_MODEL), world_size=1,
        worker_id=0, fmt="vllm", dtype=cfg.dtype))
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=CTX + SUFFIX + 8,
                        cache_engine=tier)
    eng.kept = {}
    finish = eng._finish_prefill

    def finish_and_keep(req, logits):
        eng.kept[req.request_id] = logits.float().clone()
        finish(req, logits)

    eng._finish_prefill = finish_and_keep
    return eng


def tier_serve(eng, prompt):
    """(request, first-token logits, ms from the call to a
    ``torch.cuda.synchronize()`` after it) of one prompt; the tier is
    flushed after the clock stops."""
    t0 = time.perf_counter()
    [r] = eng.generate([prompt], SamplingParams(max_new_tokens=1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    eng.cache_engine.engine_.flush()
    return r, eng.kept.pop(r.request_id), ms


def tier_ttft(eng, vocab, seed, reps=3):
    """TTFT in ms of requests on the stored CTX prefix, each with a new
    suffix drawn from ``seed`` (host clock to ``torch.cuda.synchronize()``),
    after a warm-up: (best, all). Each call takes its own seed: a tier that
    writes through to a shared store keeps the suffixes' chunks."""
    rng = np.random.default_rng(seed)
    prefix = np.random.default_rng(0).integers(0, vocab, CTX + SUFFIX,
                                               dtype=np.int32)[:CTX]
    times = []
    for i in range(reps + 1):
        prompt = np.concatenate([prefix, rng.integers(0, vocab, SUFFIX,
                                                      dtype=np.int32)])
        torch.cuda.synchronize()
        r, _, ms = tier_serve(eng, prompt)
        if r.cached_prefix_len != CTX:
            raise SystemExit(f"tiers: {r.cached_prefix_len} cached, not "
                             f"{CTX}")
        if i:
            times.append(ms)
    return min(times), times


def disk_get_seconds():
    snap = metrics.snapshot()
    key = 'lmcache_tier_get_seconds_{}{{tier="disk"}}'
    return snap.get(key.format("sum"), 0.0), snap.get(key.format("count"), 0)


def phase_tiers(cfg, params):
    """Phase 16: the disk and hybrid tiers under ``ServingEngine`` at the
    bench shape, held bit for bit to the device tier and to the remote
    path's decode. Returns (launch counts, the numbers)."""
    log(f"== phase 16: the disk and hybrid tiers, tinyllama-1.1B, CTX {CTX} "
        f"+ SUFFIX {SUFFIX}")
    tokens_np = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                  CTX + SUFFIX,
                                                  dtype=np.int32)
    launches, out = {}, {}
    device = tier_engine(cfg, params, LMCacheEngineConfig(local_device="cuda"))
    tier_serve(device, tokens_np[:CTX])  # the store-back of the prefix
    ref, ref_logits, _ = tier_serve(device, tokens_np)
    ref_kv = llama.cache_to_blob(device.kv_pool, ref.slot, CTX).clone()

    # the disk tier: engine A stores, a fresh engine B replays the index
    path = tempfile.mkdtemp(prefix="lmc-disk-")
    try:
        disk_cfg = LMCacheEngineConfig(local_device=path)
        a = tier_engine(cfg, params, disk_cfg)
        tier_serve(a, tokens_np[:CTX])  # non-blocking store-back to disk
        a.cache_engine.close()
        del a
        b = tier_engine(cfg, params, disk_cfg)
        reset_launch_counts()
        r, logits, _ = tier_serve(b, tokens_np)
        launches["disk reuse"] = read_launch_counts()
        same = (r.cached_prefix_len == ref.cached_prefix_len == CTX
                and r.output_tokens == ref.output_tokens
                and same_bits(logits, ref_logits)
                and same_bits(llama.cache_to_blob(b.kv_pool, r.slot, CTX),
                              ref_kv))
        files = len([f for f in os.listdir(path) if f.endswith(".lmtc")])
        log(f"  disk: {files} chunk files; engine B after the restart: "
            f"{r.cached_prefix_len} hits; its tokens, first-token logits and "
            f"injected KV bit-equal to the device tier's reuse: {same}; "
            f"launches {launches['disk reuse']}")
        if not same:
            raise SystemExit("disk tier: reuse differs from the device "
                             "tier's")
        s0, n0 = disk_get_seconds()
        disk_best, disk_all = tier_ttft(b, cfg.vocab_size, 16)
        s1, n1 = disk_get_seconds()
        dev_best, dev_all = tier_ttft(device, cfg.vocab_size, 17)
        log(f"  TTFT reuse from disk {disk_best:.2f} ms (best of 3 after a "
            f"warm-up; all {[round(t, 2) for t in disk_all]}; the reads warm "
            f"in the page cache), device tier {dev_best:.2f} ms (all "
            f"{[round(t, 2) for t in dev_all]}); disk get "
            f"{(s1 - s0) / max(n1 - n0, 1) * 1e3:.3f} ms a chunk over "
            f"{n1 - n0} gets (lmcache_tier_get_seconds)")
        out["disk"] = {"ttft_reuse_ms": disk_best, "ttft_all_ms": disk_all,
                       "device_ttft_reuse_ms": dev_best,
                       "device_ttft_all_ms": dev_all,
                       "get_ms_per_chunk": (s1 - s0) / max(n1 - n0, 1) * 1e3,
                       "chunk_files": files}
        b.cache_engine.close()
        del b
    finally:
        shutil.rmtree(path, ignore_errors=True)
    device.cache_engine.close()
    del device

    # the hybrid tier: the device tier in front of the cache server
    proc, url = start_cache_server()
    try:
        def hybrid(**kw):
            return tier_engine(cfg, params, LMCacheEngineConfig(
                local_device="cuda", remote_url=url, remote_serde="cachegen",
                chunk_size=REMOTE_CHUNK, **kw))

        w = hybrid()
        tier_serve(w, tokens_np[:CTX])  # write-through store-back
        w.cache_engine.close()
        del w
        remote = remote_tier(url, cfg, model_name=TIER_MODEL)
        with uncounted():
            want, mask = remote.retrieve(tokens_np[:CTX], return_tuple=False)
            torch.cuda.synchronize()
        remote.close()
        keys = [remote._make_key(h, "vllm")
                for h in prefix_chunk_hashes(tokens_np[:CTX], REMOTE_CHUNK)]
        res = {}
        for seed, kind, kw in (
                (18, "prefetch", {"hybrid_prefetch_chunks": 1024}),
                (19, "fill", {"hybrid_prefetch_chunks": 0})):
            reset_launch_counts()
            t0 = time.perf_counter()
            eng = hybrid(**kw)
            torch.cuda.synchronize()  # the prefetch's row-11 decodes
            start_ms = (time.perf_counter() - t0) * 1e3
            local = eng.cache_engine.engine_.local
            warm = sum(local.contains(k) for k in keys)
            # a suffix of its own: the instance before wrote its suffixes'
            # chunks through to the server
            prompt = np.concatenate([tokens_np[:CTX], np.random.default_rng(
                seed + 100).integers(0, cfg.vocab_size, SUFFIX,
                                     dtype=np.int32)])
            r, _, first_ms = tier_serve(eng, prompt)
            launches[f"hybrid {kind}"] = read_launch_counts()
            held = sum(local.contains(k) for k in keys)
            same = (r.cached_prefix_len == CTX and int(mask.sum()) == CTX
                    and same_bits(llama.cache_to_blob(eng.kv_pool, r.slot,
                                                      CTX), want))
            best, every = tier_ttft(eng, cfg.vocab_size, seed)
            log(f"  hybrid, {kind}: start {start_ms:.2f} ms with {warm} of "
                f"{len(keys)} chunks in the local tier; TTFT of its first "
                f"request {first_ms:.2f} ms, {r.cached_prefix_len} "
                f"hits, its injected KV bit-equal to the remote path's decode "
                f"of the same containers: {same}; then {held} of {len(keys)} "
                f"in the local tier; TTFT {best:.2f} ms (best of 3 after a "
                f"warm-up; all {[round(t, 2) for t in every]}); launches "
                f"{launches[f'hybrid {kind}']}")
            if not same or held != len(keys) or (
                    kind == "prefetch" and warm != len(keys)):
                raise SystemExit(f"hybrid tier, {kind}: a gate failed")
            res[kind] = {"start_ms": start_ms, "warm_chunks": warm,
                         "first_request_ms": first_ms, "ttft_ms": best,
                         "ttft_all_ms": every}
            eng.cache_engine.close()
            del eng
        out["hybrid"] = res
    finally:
        stop_process(proc)
    torch.cuda.empty_cache()
    return launches, out


# ------------------------------- phase 17: HuggingFace checkpoints in ---

MLA_CHECKPOINT_LAYERS = 3  # V2-Lite's depth here: its dense layer, two MoE
CHECKPOINT_PROMPT = 2048  # V2-Lite's prefill in phase 17
ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}


def write_safetensors(name, tensors):
    """One ``.safetensors`` file of ``tensors`` ((name, tensor) pairs, any
    device), written a tensor at a time: an 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes), the raw bytes.
    Returns the bytes written."""
    header, off = {}, 0
    for key, t in tensors:
        n = t.numel() * t.element_size()
        header[key] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(name, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for _, t in tensors:
            host = t.contiguous().cpu()
            f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(head) + off


def write_checkpoint(path, config, tensors):
    """A HF checkpoint directory: ``config.json`` and ``tensors`` in two
    safetensors shards with their index. Returns the weights' bytes."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    half = len(tensors) // 2
    weight_map, total = {}, 0
    for i, part in enumerate((tensors[:half], tensors[half:])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        total += write_safetensors(os.path.join(path, fname), part)
        weight_map.update({key: fname for key, _ in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def hf_llama_checkpoint(cfg, params):
    """(config.json, tensors) of a dense llama tree in HF's layout: torch
    Linear weights ``[out, in]``, HF names."""
    config = {"model_type": "llama", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim,
              "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.n_heads,
              "num_key_value_heads": cfg.n_kv_heads,
              "max_position_embeddings": cfg.max_seq_len,
              "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
              "tie_word_embeddings": False, "torch_dtype": cfg.dtype}
    lp = params["layers"]
    out = [("model.embed_tokens.weight", params["embed"])]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", lp["attn_norm"][i]),
                (p + "post_attention_layernorm.weight", lp["mlp_norm"][i])]
        out += [(p + f"self_attn.{hf}.weight", lp[key][i].T)
                for key, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                                ("wv", "v_proj"), ("wo", "o_proj"))]
        out += [(p + f"mlp.{hf}.weight", lp[key][i].T)
                for key, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                                ("w_down", "down_proj"))]
    out += [("model.norm.weight", params["final_norm"]),
            ("lm_head.weight", params["lm_head"].T)]
    return config, out


def hf_mla_checkpoint(cfg, params):
    """(config.json, tensors) of a DeepSeek-V2 tree (direct q_proj, greedy
    gate) in HF's layout: ``kv_b_proj`` rebuilt as ``[H * (n + v), r]``
    from ``w_kb_k`` and ``w_kb_v``, per-expert Linear weights."""
    config = {"model_type": "deepseek_v2", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim,
              "moe_intermediate_size": cfg.moe_hidden_dim,
              "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.n_heads,
              "num_key_value_heads": cfg.n_heads,
              "max_position_embeddings": cfg.max_seq_len,
              "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
              "q_lora_rank": cfg.q_lora_rank,
              "kv_lora_rank": cfg.kv_lora_rank,
              "qk_nope_head_dim": cfg.qk_nope_head_dim,
              "qk_rope_head_dim": cfg.qk_rope_head_dim,
              "v_head_dim": cfg.v_head_dim,
              "first_k_dense_replace": cfg.first_k_dense_replace,
              "n_routed_experts": cfg.n_routed_experts,
              "n_shared_experts": cfg.n_shared_experts,
              "num_experts_per_tok": cfg.n_experts_per_tok,
              "routed_scaling_factor": cfg.routed_scaling_factor,
              "topk_method": cfg.topk_method,
              "norm_topk_prob": cfg.norm_topk_prob,
              "rope_scaling": {
                  "type": "yarn", "factor": cfg.rope_scaling_factor,
                  "beta_fast": cfg.rope_beta_fast,
                  "beta_slow": cfg.rope_beta_slow,
                  "mscale": cfg.rope_mscale,
                  "mscale_all_dim": cfg.rope_mscale_all_dim,
                  "original_max_position_embeddings":
                      cfg.rope_original_max_seq},
              "tie_word_embeddings": False, "torch_dtype": cfg.dtype}
    H = cfg.n_heads
    out = [("model.embed_tokens.weight", params["embed"])]
    kd = cfg.n_dense_layers
    for i in range(cfg.n_layers):
        moe = i >= kd
        lp = params["moe_layers" if moe else "dense_layers"]
        j = i - kd if moe else i
        p = f"model.layers.{i}."
        kb = torch.cat([lp["w_kb_k"][j], lp["w_kb_v"][j].transpose(1, 2)],
                       dim=1).reshape(-1, cfg.kv_lora_rank)
        assert kb.shape[0] == H * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        out += [(p + "input_layernorm.weight", lp["attn_norm"][j]),
                (p + "post_attention_layernorm.weight", lp["mlp_norm"][j]),
                (p + "self_attn.q_proj.weight", lp["wq"][j].T),
                (p + "self_attn.kv_a_proj_with_mqa.weight", lp["wkv_a"][j].T),
                (p + "self_attn.kv_a_layernorm.weight", lp["kv_a_norm"][j]),
                (p + "self_attn.kv_b_proj.weight", kb),
                (p + "self_attn.o_proj.weight", lp["wo"][j].T)]
        names = (("gate_proj", "gate"), ("up_proj", "up"),
                 ("down_proj", "down"))
        if not moe:
            out += [(p + f"mlp.{hf}.weight", lp["w_" + k][j].T)
                    for hf, k in names]
            continue
        out.append((p + "mlp.gate.weight", lp["router"][j].T))
        for e in range(cfg.n_routed_experts):
            out += [(p + f"mlp.experts.{e}.{hf}.weight", lp["e_" + k][j, e].T)
                    for hf, k in names]
        out += [(p + f"mlp.shared_experts.{hf}.weight", lp["s_" + k][j].T)
                for hf, k in names]
    out += [("model.norm.weight", params["final_norm"]),
            ("lm_head.weight", params["lm_head"].T)]
    return config, out


def _rss_bytes():
    """This process's resident set in bytes: (total, anonymous, file)."""
    kb = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS:", "RssAnon:", "RssFile:")):
                name, value = line.split(":")
                kb[name] = int(value.split()[0])
    return tuple(kb.get(k, 0) * 1024 for k in ("VmRSS", "RssAnon",
                                               "RssFile"))


def host_memory_during(fn):
    """(fn's result, seconds, the largest growth of this process's resident
    set over its size before the call, sampled every 2 ms: total,
    anonymous and file-backed, and the growth of its peak resident set by
    ``resource.getrusage``), in bytes."""
    import resource
    import threading
    base, peak = _rss_bytes(), [0, 0, 0]
    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[:] = [max(p, r - b)
                       for p, r, b in zip(peak, _rss_bytes(), base)]
            time.sleep(0.002)

    maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        secs = time.perf_counter() - t0
        done.set()
        sampler.join()
    peak[:] = [max(p, r - b) for p, r, b in zip(peak, _rss_bytes(), base)]
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return out, secs, peak, (maxrss - maxrss0) * 1024


def _flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def trees_same_bits(a, b):
    """The keys of two parameter trees that differ (names, shapes, dtypes
    or bits)."""
    fa, fb = _flat_params(a), _flat_params(b)
    bad = sorted(set(fa) ^ set(fb))
    bad += [k for k in sorted(set(fa) & set(fb))
            if not same_bits(fa[k], fb[k])]
    return bad


def load_checkpoint(name, module, cfg_cls, want_cfg, params, path,
                    hf_writer):
    """Write ``params`` as a HF checkpoint directory, read it back with
    ``cfg_cls.from_hf`` and ``module.load_hf(device="cuda")``; gate the
    config field for field and the parameters bit for bit. Returns (the
    loaded parameters, the numbers)."""
    t0 = time.perf_counter()
    config, tensors = hf_writer(want_cfg, params)
    nbytes = write_checkpoint(path, config, tensors)
    del tensors
    write_s = time.perf_counter() - t0
    got_cfg = cfg_cls.from_hf(path)
    same_cfg = dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    (_, loaded), load_s, (rss_peak, anon, mapped), maxrss = (
        host_memory_during(lambda: module.load_hf(path, device="cuda")))
    bad = trees_same_bits(loaded, params)
    log(f"  {name}: checkpoint {nbytes / 1e9:.3f} GB in two safetensors "
        f"shards written in {write_s:.2f} s; from_hf equals the config field "
        f"for field: {same_cfg}; load_hf {load_s:.2f} s "
        f"({nbytes / 1e9 / load_s:.2f} GB/s), host resident set +"
        f"{rss_peak / 1e6:.1f} MB at its peak (sampled; anonymous +"
        f"{anon / 1e6:.1f}, file-backed +{mapped / 1e6:.1f}), peak RSS +"
        f"{maxrss / 1e6:.1f} MB (getrusage); parameters bit-equal to the "
        f"in-memory tree: {not bad} {bad[:4] if bad else ''}")
    if not same_cfg or bad:
        raise SystemExit(f"checkpoints, {name}: the loaded config or "
                         f"parameters differ")
    return loaded, {"checkpoint_bytes": nbytes, "write_s": write_s,
                    "load_s": load_s, "host_rss_peak_growth_bytes": rss_peak,
                    "host_rss_anon_peak_growth_bytes": anon,
                    "host_rss_file_peak_growth_bytes": mapped,
                    "host_maxrss_growth_bytes": maxrss}


def prefill_and_step(cfg, params, module, tokens, cache):
    """The last prompt position's logits of a prefill of ``tokens`` [1, T]
    and of one decode step of its greedy token, over ``cache``."""
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    logits, _ = module.forward(params, cfg, tokens, zero, cache,
                               last_logit_only=True)
    first = logits[0, -1]
    nxt = first.argmax().reshape(1, 1)
    pos = torch.full((1,), tokens.shape[1], dtype=torch.int32, device="cuda")
    step, _ = module.forward(params, cfg, nxt, pos, cache)
    return first, step[0, -1]


def phase_checkpoints(cfg, params, phase3_logits):
    """Phase 17: tinyllama-1.1B (phase 3's weights) and DeepSeek-V2-Lite at
    MLA_CHECKPOINT_LAYERS layers written as HF checkpoint directories and
    read back through the loaders. Returns (launch counts, the numbers,
    the loaded tinyllama parameters)."""
    log("== phase 17: HuggingFace checkpoints in: tinyllama-1.1B (phase 3's "
        f"weights) and DeepSeek-V2-Lite at {MLA_CHECKPOINT_LAYERS} layers")
    launches, out = {}, {}
    root = tempfile.mkdtemp(prefix="lmc-hf-")
    try:
        loaded, out["tinyllama"] = load_checkpoint(
            "tinyllama-1.1B", llama, llama.LlamaConfig, cfg, params,
            os.path.join(root, "tinyllama"), hf_llama_checkpoint)
        S = CTX + SUFFIX
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, S, dtype=np.int32), device="cuda").long()[None]
        reset_launch_counts()
        cache = llama.new_kv_cache(cfg, 1, S + 1)
        first, step = prefill_and_step(cfg, loaded, llama, tokens, cache)
        launches["checkpoint tinyllama"] = read_launch_counts()
        with uncounted():
            cache.zero_()
            _, step_mem = prefill_and_step(cfg, params, llama, tokens, cache)
        del cache
        same_first = same_bits(first, phase3_logits)
        same_step = same_bits(step, step_mem)
        log(f"  tinyllama-1.1B from the checkpoint: first-token logits of "
            f"phase 3's {S}-token prefill bit-equal to phase 3's: "
            f"{same_first}; a decode step bit-equal to the in-memory "
            f"weights': {same_step}; launches "
            f"{launches['checkpoint tinyllama']}")
        if not (same_first and same_step):
            raise SystemExit("checkpoints: the loaded tinyllama's logits "
                             "differ")

        mcfg = dataclasses.replace(MLA_CFG, n_layers=MLA_CHECKPOINT_LAYERS)
        free_device_memory()
        mparams = mla.init_params(
            mcfg, generator=torch.Generator(device="cuda").manual_seed(0))
        mloaded, out["v2_lite"] = load_checkpoint(
            f"DeepSeek-V2-Lite ({MLA_CHECKPOINT_LAYERS} layers: dense, MoE, "
            "MoE)", mla, mla.MLAConfig, mcfg, mparams,
            os.path.join(root, "v2-lite"), hf_mla_checkpoint)
        mtokens = torch.as_tensor(np.random.default_rng(17).integers(
            0, mcfg.vocab_size, CHECKPOINT_PROMPT, dtype=np.int32),
            device="cuda").long()[None]
        reset_launch_counts()
        got = prefill_and_step(mcfg, mloaded, mla, mtokens,
                               mla.new_latent_cache(mcfg, 1,
                                                    CHECKPOINT_PROMPT + 1))
        launches["checkpoint v2-lite"] = read_launch_counts()
        with uncounted():
            want = prefill_and_step(mcfg, mparams, mla, mtokens,
                                    mla.new_latent_cache(
                                        mcfg, 1, CHECKPOINT_PROMPT + 1))
        same = all(same_bits(a, b) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log(f"  DeepSeek-V2-Lite from the checkpoint: a {CHECKPOINT_PROMPT}"
            f"-token prefill's last logits and a decode step bit-equal to "
            f"the in-memory weights': {same}, finite {finite}; launches "
            f"{launches['checkpoint v2-lite']}")
        if not (same and finite):
            raise SystemExit("checkpoints: the loaded V2-Lite's logits "
                             "differ")
        del mparams, mloaded, got, want
        free_device_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, out, loaded


# ---------------------------------- phase 18: the OpenAI-compatible front ---

HTTP_PROMPT = 2048  # tokens of the completion prompts
HTTP_NEW = 16  # tokens a completion decodes
HTTP_BATCH = 8  # concurrent completions (and the engine's slots)
HTTP_LOGPROBS = 2
HTTP_SEQ = HTTP_PROMPT + 64  # max_seq of the engine


def http_call(port, method, path, body=None):
    """(status, parsed JSON body, ms to the whole response) of one request
    over ``http.client``."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request(method, path, body=None if body is None else
                 json.dumps(body), headers={"Content-Type":
                                            "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    conn.close()
    ctype = resp.getheader("Content-Type", "")
    return resp.status, (json.loads(data) if "json" in ctype
                         else data.decode()), ms


def http_stream(port, body):
    """(the SSE payloads, ms from the request to the first ``data:`` line)
    of one streamed completion."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, first_ms = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
            if line.strip() == b"data: [DONE]":
                break
            events.append(json.loads(line[6:]))
    conn.close()
    return events, first_ms


def expected_stop_text(detok, tokens, stop):
    """The text the server must return for greedy ``tokens`` under the stop
    string ``stop``: the tokens up to the first at which the text holds it,
    cut where it begins."""
    for n in range(1, len(tokens) + 1):
        text = detok(tokens[:n])
        i = text.find(stop)
        if i != -1:
            return text[:i], n
    return detok(tokens), len(tokens)


def phase_http(cfg, params):
    """Phase 18: the port's ``APIServer`` over a ``ServingEngine`` with the
    loaded tinyllama and a "cuda" tier, on 127.0.0.1, driven through
    ``http.client``. Greedy tokens over HTTP are held bit for bit to the
    same engine driven directly in the same cache state (a miss: the
    engine's tier swapped for an empty one, under the server's lock).
    Returns (launch counts, the numbers)."""
    from lmcache_tpu_torch.serving.api import APIServer
    log(f"== phase 18: the OpenAI-compatible HTTP front, tinyllama-1.1B "
        f"(the loaded checkpoint), {HTTP_PROMPT}-token prompts, "
        f"{HTTP_BATCH} slots, a \"cuda\" tier")
    meta = LMCacheEngineMetadata(model_name="tinyllama-1.1b-http",
                                 world_size=1, worker_id=0, fmt="vllm",
                                 dtype=cfg.dtype)

    def tier():
        return LMCacheEngine(LMCacheEngineConfig(local_device="cuda"), meta)

    eng = ServingEngine(cfg, params, max_batch=HTTP_BATCH, max_seq=HTTP_SEQ,
                        cache_engine=tier())
    # each token's text carries its leading space, as a BPE vocabulary's
    # do: a stream's per-token texts concatenate to the whole text
    srv = APIServer(eng, model_name="tinyllama-1.1b",
                    tokenizer=lambda s: list(s.encode()),
                    detokenizer=lambda toks: "".join(f" {t}" for t in toks))
    detok = srv.detokenizer
    rng = np.random.default_rng(18)

    def prompt():
        return rng.integers(0, cfg.vocab_size, HTTP_PROMPT,
                            dtype=np.int32).tolist()

    def direct(prompts, sps):
        """The engine driven directly on an empty tier (a miss, as the
        HTTP request before it was), uncounted, under the server's lock."""
        with srv._lock, uncounted():
            kept, eng.cache_engine = eng.cache_engine, tier()
            try:
                reqs = [eng.add_request(Request(np.asarray(p, np.int32), sp))
                        for p, sp in zip(prompts, sps)]
                eng.run()
            finally:
                eng.cache_engine.close()
                eng.cache_engine = kept
        return [r.output_tokens for r in reqs]

    def flush():
        with srv._lock:
            eng.cache_engine.engine_.flush()

    greedy = SamplingParams(max_new_tokens=HTTP_NEW)
    srv.start()
    reset_launch_counts()
    port = srv.listen("127.0.0.1", 0)
    ok, out = True, {}
    try:
        s1, health, _ = http_call(port, "GET", "/health")
        s2, models, _ = http_call(port, "GET", "/v1/models")
        ok &= (s1 == s2 == 200 and health == {"status": "ok"}
               and models["data"][0]["id"] == "tinyllama-1.1b")
        log(f"  /health {s1} {health}; /v1/models {s2} "
            f"{[m['id'] for m in models['data']]}")

        # one completion (a miss), held to the engine driven directly
        p = prompt()
        body = {"prompt": p, "max_tokens": HTTP_NEW}
        st, resp, ms = http_call(port, "POST", "/v1/completions", body)
        [want] = direct([p], [greedy])
        got = resp["choices"][0]["tokens"]
        same = st == 200 and got == want
        ok &= same
        flush()
        log(f"  completion of {HTTP_PROMPT} tokens (a miss): {len(got)} "
            f"tokens in {ms:.2f} ms, ttft_ms {resp['usage']['ttft_ms']}; "
            f"bit-equal to the engine driven directly: {same}")
        out["completion_ms"] = ms
        out["completion_ttft_ms"] = resp["usage"]["ttft_ms"]

        # the same prompt (a hit), plain and streamed
        st, hit, _ = http_call(port, "POST", "/v1/completions", body)
        events, first_ms = http_stream(
            port, dict(body, stream=True,
                       stream_options={"include_usage": True}))
        text = "".join(e["choices"][0]["text"] for e in events
                       if e["choices"])
        toks = [e["choices"][0]["token"] for e in events
                if e["choices"] and "token" in e["choices"][0]]
        usage = events[-1]["usage"]
        same = (st == 200 and text == hit["choices"][0]["text"]
                and toks == hit["choices"][0]["tokens"])
        hit_cached = hit["usage"]["prompt_tokens_details"]["cached_tokens"]
        ok &= same and hit_cached == HTTP_PROMPT - 1
        log(f"  the same prompt again: {hit_cached} "
            f"cached tokens; streamed text equals the non-streamed text: "
            f"{same}; stream: usage.ttft_ms {usage['ttft_ms']} against the "
            f"client's {first_ms:.2f} ms to the first byte of data: the "
            f"HTTP front's part {first_ms - usage['ttft_ms']:.2f} ms")
        out["stream"] = {"ttft_ms": usage["ttft_ms"],
                         "client_first_data_ms": first_ms,
                         "http_overhead_ms": first_ms - usage["ttft_ms"],
                         "cached_tokens": usage["prompt_tokens_details"][
                             "cached_tokens"]}
        flush()

        # HTTP_BATCH concurrent completions (misses)
        import threading
        prompts = [prompt() for _ in range(HTTP_BATCH)]
        results = [None] * HTTP_BATCH

        def call(i):
            results[i] = http_call(port, "POST", "/v1/completions",
                                   {"prompt": prompts[i],
                                    "max_tokens": HTTP_NEW})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(HTTP_BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = (time.perf_counter() - t0) * 1e3
        wants = direct(prompts, [greedy] * HTTP_BATCH)
        same = [r[0] == 200 and r[1]["choices"][0]["tokens"] == w
                for r, w in zip(results, wants)]
        ok &= all(same)
        ttfts = [r[1]["usage"]["ttft_ms"] for r in results]
        log(f"  {HTTP_BATCH} concurrent completions: {wall:.2f} ms wall, "
            f"ttft_ms {ttfts}; each bit-equal to the engine driven directly: "
            f"{same}")
        out["concurrent"] = {"wall_ms": wall, "ttft_ms": ttfts,
                             "tokens_per_s": HTTP_BATCH * HTTP_NEW
                             / (wall / 1e3)}
        flush()

        # n = 2 sampled with a seed: the requests seeded seed and seed + 1
        q = prompt()
        sp = dict(max_new_tokens=HTTP_NEW, temperature=0.8, top_k=50)
        st, resp, _ = http_call(port, "POST", "/v1/completions",
                                {"prompt": q, "max_tokens": HTTP_NEW,
                                 "n": 2, "seed": 11, "temperature": 0.8,
                                 "top_k": 50})
        wants = direct([q, q], [SamplingParams(seed=s, **sp)
                                for s in (11, 12)])
        got = [c["tokens"] for c in resp["choices"]]
        same = st == 200 and got == wants and got[0] != got[1]
        ok &= same
        log(f"  n = 2, seed 11, temperature 0.8: the choices are the "
            f"engine's requests seeded 11 and 12, bit for bit: {same}")
        flush()

        # a stop string from the greedy text (the hit's, the same state)
        ref = hit["choices"][0]["tokens"]
        stop = " " + str(ref[5])
        want_text, want_n = expected_stop_text(detok, ref, stop)
        st, resp, _ = http_call(port, "POST", "/v1/completions",
                                dict(body, stop=[stop]))
        c = resp["choices"][0]
        same = (st == 200 and c["finish_reason"] == "stop"
                and c["text"] == want_text and c["tokens"] == ref[:want_n])
        ok &= same
        log(f"  stop {stop!r}: finish_reason {c['finish_reason']}, "
            f"{len(c['tokens'])} tokens, the text cut before the stop "
            f"string: {same}")

        # logprobs against the fp32 witness
        st, resp, _ = http_call(port, "POST", "/v1/completions",
                                dict(body, logprobs=HTTP_LOGPROBS))
        c = resp["choices"][0]
        lp = c["logprobs"]
        recs = [{"token": int(t), "logprob": v,
                 "top": [(int(k), x) for k, x in top.items()]}
                for t, v, top in zip(lp["tokens"], lp["token_logprobs"],
                                     lp["top_logprobs"])]
        from types import SimpleNamespace
        seq = np.asarray(p + c["tokens"][:-1], np.int32)
        witness = witness_logits(cfg, params, [seq])
        lp_ok, worst = logprobs_agree(
            "logprobs over HTTP", [SimpleNamespace(logprobs=recs)], [p],
            witness, k=HTTP_LOGPROBS)
        ok &= st == 200 and lp_ok and c["tokens"] == ref
        out["logprobs_worst"] = worst
        flush()

        # a three-turn chat: cached_tokens climbs (flushed between turns)
        msgs = [{"role": "system", "content": "You answer in numbers. " * 30},
                {"role": "user", "content": "Count the cached chunks. " * 12}]
        cached, ttfts = [], []
        for turn in range(3):
            st, resp, _ = http_call(port, "POST", "/v1/chat/completions",
                                    {"messages": msgs,
                                     "max_tokens": HTTP_NEW})
            if st != 200:
                raise SystemExit(f"http: chat turn {turn + 1}: {st} {resp}")
            cached.append(resp["usage"]["prompt_tokens_details"][
                "cached_tokens"])
            ttfts.append(resp["usage"]["ttft_ms"])
            flush()
            msgs = msgs + [resp["choices"][0]["message"],
                           {"role": "user",
                            "content": f"And turn {turn + 2}? " * 16}]
        climbs = cached[0] == 0 and 0 < cached[1] < cached[2]
        ok &= climbs
        log(f"  three-turn chat: cached_tokens {cached}, climbing: {climbs}; "
            f"ttft_ms {ttfts}")
        out["chat"] = {"cached_tokens": cached, "ttft_ms": ttfts}
        st, text, _ = http_call(port, "GET", "/metrics")
        ok &= st == 200 and "lmcache_chunks_stored" in text
    finally:
        srv.stop()
    launches = {"http": read_launch_counts()}
    log(f"  launches {launches['http']}")
    eng.cache_engine.close()
    if not ok:
        raise SystemExit("http: a gate failed")
    return launches, out


# ------------------------------------------ phase 19: the engine hook API ---

HOOK_PROMPT, HOOK_SUFFIX = 4096, 512


def phase_hooks(cfg, params):
    """Phase 19: an outside loop at tinyllama-1.1B's full depth over the
    hook API: prefill a prompt into its own pool, store the blob, then for
    the prompt plus a suffix retrieve the prefix through both hooks, inject
    it and prefill the rest. Returns (launch counts, the numbers)."""
    from lmcache_tpu_torch import integration as itg
    log(f"== phase 19: the engine hook API, an outside loop, tinyllama-1.1B, "
        f"{HOOK_PROMPT} + {HOOK_SUFFIX} tokens")
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, cfg.vocab_size, HOOK_PROMPT, dtype=np.int32)
    tokens = np.concatenate([prompt, rng.integers(
        0, cfg.vocab_size, HOOK_SUFFIX, dtype=np.int32)])
    S = len(tokens)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    itg.close_lmcache_engine()
    eng = itg.init_lmcache_engine(
        "tinyllama-1.1b-hooks", dtype=cfg.dtype,
        config=LMCacheEngineConfig(local_device="cuda"))
    out, launches = {}, {}
    try:
        reset_launch_counts()
        cache = llama.new_kv_cache(cfg, 1, S)
        llama.forward(params, cfg, torch.as_tensor(
            prompt, device="cuda").long()[None], zero, cache,
            last_logit_only=True)
        torch.cuda.synchronize()
        launches["hooks store"] = read_launch_counts()
        step = itg.StepInput(tokens=prompt, is_prefill=True)
        if not itg.lmcache_should_store(step):
            raise SystemExit("hooks: a prefill step is not stored")
        t0 = time.perf_counter()
        itg.lmcache_store_kv(step, llama.cache_to_blob(cache, 0,
                                                       HOOK_PROMPT))
        store_ms = (time.perf_counter() - t0) * 1e3
        eng.engine_.flush()
        del cache

        def reuse():
            step = itg.StepInput(tokens=tokens, is_prefill=True)
            if not itg.lmcache_should_retrieve(step):
                raise SystemExit("hooks: a prefill step is not retrieved")
            step = itg.lmcache_retrieve_kv(step)
            if step.num_computed_tokens != HOOK_PROMPT:
                raise SystemExit(f"hooks: {step.num_computed_tokens} tokens "
                                 f"retrieved, not {HOOK_PROMPT}")
            cache = llama.blob_into_cache(llama.new_kv_cache(cfg, 1, S),
                                          step.retrieved_kv)
            rest = itg.build_partial_prefill_input(step)
            logits, _ = llama.forward(
                params, cfg, torch.as_tensor(rest, device="cuda").long()[None],
                torch.full((1,), step.num_computed_tokens, dtype=torch.int32,
                           device="cuda"), cache, last_logit_only=True)
            return step, logits[0, -1]

        def full():
            logits, _ = llama.forward(
                params, cfg, torch.as_tensor(tokens, device="cuda").long()[
                    None], zero, llama.new_kv_cache(cfg, 1, S),
                last_logit_only=True)
            return logits[0, -1]

        reset_launch_counts()
        step, reuse_logits = reuse()
        torch.cuda.synchronize()
        launches["hooks"] = read_launch_counts()
        with uncounted():
            full_logits = full()
            pieces = list(itg.lmcache_retrieve_kv_stream(
                itg.StepInput(tokens=tokens, is_prefill=True)))
            rebuilt = torch.cat([c for _, c in pieces], dim=2)
            gen = itg.lmcache_retrieve_kv_stream(
                itg.StepInput(tokens=tokens, is_prefill=True))
            first_start = next(gen)[0]
            gen.close()
            again = itg.lmcache_retrieve_kv(
                itg.StepInput(tokens=tokens, is_prefill=True))
            t_reuse = wall_best(lambda: reuse())
            t_full = wall_best(full)
        rel = ((reuse_logits - full_logits).norm()
               / full_logits.norm()).item()
        same_top = int(reuse_logits.argmax()) == int(full_logits.argmax())
        stream_same = same_bits(rebuilt, step.retrieved_kv)
        usable = (first_start == 0 and again.num_computed_tokens
                  == HOOK_PROMPT and same_bits(again.retrieved_kv,
                                               step.retrieved_kv))
        log(f"  stored the {HOOK_PROMPT}-token blob in {store_ms:.2f} ms "
            f"(non-blocking); retrieved {step.num_computed_tokens} tokens; "
            f"reuse logits rel_l2 {rel:.3e} (tolerance {REL_L2_REUSE}) same "
            f"top-1 {same_top}; {len(pieces)} streamed pieces bit-equal to "
            f"the retrieved blob: {stream_same}; a stream closed after its "
            f"first piece leaves the engine usable: {usable}; TTFT through "
            f"the hooks {t_reuse:.2f} ms against a full prefill "
            f"{t_full:.2f} ms (best of 3 after a warm-up); launches of "
            f"the outside loop's first prefill {launches['hooks store']}, "
            f"of the reuse alone {launches['hooks']}")
        if not (step.num_computed_tokens == HOOK_PROMPT and same_top
                and rel <= REL_L2_REUSE and stream_same and usable):
            raise SystemExit("hooks: a gate failed")
        out = {"retrieved": step.num_computed_tokens, "rel_l2": rel,
               "pieces": len(pieces), "store_ms": store_ms,
               "ttft_reuse_ms": t_reuse, "ttft_full_ms": t_full}
    finally:
        itg.close_lmcache_engine()
    return launches, out


# ------------------------------------------- phase 20: the examples ---

def phase_examples(url):
    """Phase 20: every example of ``lmcache_tpu_torch/examples`` through its
    ``main()`` on the card (tinyllama-1.1B; DeepSeek-V2-Lite at 3 layers for
    the MLA one), the three that need a cache server on the shared one at
    ``url``. Each example raises when its claim fails; the figures it
    returns are held here too. Returns (launch counts by example, the
    figures)."""
    from lmcache_tpu_torch.examples import (
        disaggregated_prefill, mla_latent_cache, offline_inference,
        online_session, rag_blend, save_decode_cache, speculative_decode)
    from lmcache_tpu_torch.examples.share_across_instances import share
    from lmcache_tpu_torch.examples.storage_backends import round_trip
    log("== phase 20: the examples (lmcache_tpu_torch/examples) on the card")
    runs = (("offline_inference", offline_inference.main, {}),
            ("save_decode_cache", save_decode_cache.main, {}),
            ("online_session", online_session.main, {}),
            ("share_across_instances", share.main, {"url": url}),
            ("disaggregated_prefill", disaggregated_prefill.main,
             {"url": url}),
            ("storage_backends", round_trip.main, {"url": url}),
            ("rag_blend", rag_blend.main, {}),
            ("speculative_decode", speculative_decode.main, {}),
            ("mla_latent_cache", mla_latent_cache.main, {}))
    launches, out = {}, {}
    for name, main_fn, kw in runs:
        log(f"  -- {name}")
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out[name] = main_fn("cuda", **kw)
        except RuntimeError as e:
            raise SystemExit(f"example {name}: {e}")
        torch.cuda.synchronize()
        out[name]["seconds"] = time.perf_counter() - t0
        launches[f"example {name}"] = read_launch_counts()
        log(f"  {name}: {out[name]['seconds']:.1f} s; launches "
            f"{launches[f'example {name}']}")
        torch.cuda.empty_cache()

    o, sd = out["offline_inference"], out["save_decode_cache"]
    on, sh = out["online_session"], out["share_across_instances"]
    dp, st = out["disaggregated_prefill"], out["storage_backends"]
    rg, sp = out["rag_blend"], out["speculative_decode"]
    ml = out["mla_latent_cache"]
    climbs = on["cached_tokens"]
    gates = {
        "offline inference: the second request hits, the same tokens":
            o["cached_prefix_len"][1] > 0 and o["tokens"][0] == o["tokens"][1],
        "save decode cache: round 2 hits the generated tokens":
            sd["with"] > sd["prompt"] and sd["with"] > sd["without"],
        "online session: cached_tokens climbs":
            all(b > a for a, b in zip(climbs, climbs[1:])),
        "share across instances: B decodes A's tokens":
            sh["cached_prefix_len"][1] > 0
            and sh["tokens"][0] == sh["tokens"][1],
        "disaggregated prefill: one instance's own tokens":
            dp["cached_prefix_len"] > 0 and dp["tokens"] == dp["reference"],
        "storage backends: bit for bit, hybrid_cachegen within the PSNR":
            all(r["exact"] if n != "hybrid_cachegen.yaml"
                else r["psnr_db"] >= round_trip.PSNR_DB
                for n, r in st.items() if n != "seconds"),
        "CacheBlend: closer to the full prefill than naive reuse":
            rg["rel_l2"] < rg["rel_l2_naive"],
        "speculative decode: greedy tokens in fewer engine steps":
            sp["accepted"] > 0 and sp["steps_spec"] < sp["steps_plain"],
        "MLA latent cache: the reuse decodes the full prefill's tokens":
            ml["cached_prefix_len"] > 0 and ml["tokens"][0] == ml["tokens"][1]
            and ml["bytes_ratio"] == 2 * 8 * 128 / mla_latent_cache.mla_config(
                "cuda").latent_dim,
    }
    for claim, ok in gates.items():
        log(f"  {claim}: {'ok' if ok else 'FAILED'}")
    failed = [claim for claim, ok in gates.items() if not ok]
    if failed:
        raise SystemExit("phase 20: " + "; ".join(failed))
    return launches, out


# ------------------------------------------- phase 21: training on the card ---

TRAIN_CHECK_LR = 5e-4  # 21a's one update: the --init rate, held constant
# 21a's rule, the card (fp32, TF32 off) against the CPU on one batch of the
# committed checkpoints, whose loss is 0.001-0.003: the loss is the log of
# a probability near 1 (fp32 rounds logits near 16 to 1e-6), each gradient
# leaf a sum of near-cancelling terms (relative L2; the CPU's fp32 lies
# 5e-5 from its fp64 there), and AdamW's first update lr x g / (|g| +
# eps) flips with the sign of the gradient elements smaller than their
# rounding (6.5e-6 of them between the CPU's fp32 and fp64: a relative L2
# of the updates of 7e-4)
TRAIN_LOSS_ATOL = 1e-6
TRAIN_GRAD_REL_L2 = 2e-3
TRAIN_UPDATE_REL_L2 = 1e-2
FROM_SEED_STEPS = 200  # 21b: the first steps of the tool's 5600-step run
FROM_SEED_RUN = 5600
FINETUNE_STEPS = 10  # 21c
LONG_T, LONG_R = 8256, 2048
COPY_ACC = 0.99  # the JAX checkpoint tests' rule


def train_step_against_cpu(family, cfg, path):
    """21a: one step of ``Trainer`` on the card and on the CPU from the
    committed checkpoint, on ``make_train_batch(default_rng(0), 4, 256,
    32)``."""
    tokens = quality_common.make_train_batch(np.random.default_rng(0), 4,
                                             256, 32)
    mask = quality_common.target_mask(256, 32)
    res = {}
    for dev in ("cuda", "cpu"):
        params = quality_common.load_params(cfg, path, device=dev)
        trainer = train_tool.Trainer(cfg, params,
                                     lambda count: TRAIN_CHECK_LR)
        before = [p.detach().to("cpu", copy=True) for _, p in trainer.named]
        loss, acc = trainer.gradients(tokens, mask)
        grads = [p.grad.detach().to("cpu", copy=True)
                 for _, p in trainer.named]
        trainer.update()
        update = torch.cat([(p.detach().cpu() - b).flatten() for (_, p), b
                            in zip(trainer.named, before)])
        res[dev] = (loss, acc, grads, update)
    (loss, acc, grads, upd), (loss_c, acc_c, grads_c, upd_c) = (
        res["cuda"], res["cpu"])
    grad_rel = max(float((g - w).norm() / w.norm().clamp_min(1e-30))
                   for g, w in zip(grads, grads_c))
    upd_rel = float((upd - upd_c).norm() / upd_c.norm())
    flipped = float((upd * upd_c < 0).float().mean())
    ok = (abs(loss - loss_c) <= TRAIN_LOSS_ATOL and acc == acc_c
          and grad_rel <= TRAIN_GRAD_REL_L2
          and upd_rel <= TRAIN_UPDATE_REL_L2)
    log(f"  21a {family}: loss {loss:.8f} on the card, {loss_c:.8f} on the "
        f"CPU (atol {TRAIN_LOSS_ATOL}); accuracy {acc:.4f} / {acc_c:.4f}; "
        f"worst gradient leaf rel_l2 {grad_rel:.3e} (at most "
        f"{TRAIN_GRAD_REL_L2}); the updates' rel_l2 {upd_rel:.3e} (at most "
        f"{TRAIN_UPDATE_REL_L2}), {flipped:.2e} of them of the other sign, "
        f"max |diff| {float((upd - upd_c).abs().max()):.3e}: "
        f"{'ok' if ok else 'FAILED'}")
    return {"loss": loss, "loss_cpu": loss_c, "acc": acc, "acc_cpu": acc_c,
            "grad_worst_rel_l2": grad_rel, "update_rel_l2": upd_rel,
            "update_flipped": flipped, "ok": ok}


def train_from_seed():
    """21b: the dense model from seed 0 through the first FROM_SEED_STEPS
    steps of the tool's run (stage 1 of ``CURRICULUM``, T 256, batch 64);
    the mean loss of the last 20 steps must lie below the first 20's."""
    cfg = quality_common.quality_config()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    trainer = train_tool.Trainer(
        cfg, params, train_tool.warmup_cosine_schedule(2e-3, FROM_SEED_RUN))
    rng = np.random.default_rng(0)
    losses, step_s, tokens = [], [], 0
    torch.cuda.reset_peak_memory_stats()
    for step in range(FROM_SEED_STEPS):
        T, R = train_tool.shape_for_step(step, FROM_SEED_RUN,
                                         train_tool.CURRICULUM)
        B = train_tool.batch_for(T, 32)
        batch = quality_common.make_train_batch(rng, B, T, R)
        t0 = time.perf_counter()
        loss, _ = trainer.step(batch, quality_common.target_mask(T, R))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        tokens = B * T
    steady = sorted(step_s[10:])[len(step_s[10:]) // 2]
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    peak = torch.cuda.max_memory_allocated()
    log(f"  21b from seed 0: {FROM_SEED_STEPS} steps of stage 1 (T 256, "
        f"batch {tokens // 256}): mean loss of the first 20 steps "
        f"{first:.4f}, of the last 20 {last:.4f}; step {steady * 1e3:.2f} ms "
        f"(median after 10), {tokens / steady:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; {'ok' if last < first else 'FAILED'}")
    return {"loss_first20": float(first), "loss_last20": float(last),
            "step_ms": steady * 1e3, "tokens_per_s": tokens / steady,
            "peak_bytes": peak, "ok": bool(last < first)}


def train_long_finetune(family, cfg, path):
    """21c: the --init finetune from the committed checkpoint at T 8256, R
    2048 for FINETUNE_STEPS steps under remat (the tool's default schedule
    of an --init run), then one step's gradients without remat; the copy
    accuracy of each step's batch and of the held-out band must stay at
    least COPY_ACC."""
    params = quality_common.load_params(cfg, path, device="cuda")
    trainer = train_tool.Trainer(
        cfg, params, train_tool.warmup_cosine_schedule(
            5e-4, 1400 if family == "llama" else 1000))
    B = train_tool.batch_for(LONG_T, 32, family)
    rng = np.random.default_rng(0)
    mask = quality_common.target_mask(LONG_T, LONG_R)
    torch.cuda.reset_peak_memory_stats()
    accs, step_s = [], []
    for _ in range(FINETUNE_STEPS):
        batch = quality_common.make_train_batch(rng, B, LONG_T, LONG_R)
        t0 = time.perf_counter()
        _, acc = trainer.step(batch, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        accs.append(acc)
    peak_remat = torch.cuda.max_memory_allocated()
    [(_, _, held_loss, held_acc)] = train_tool.evaluate(
        cfg, params, [(LONG_T, LONG_R)])
    trainer.opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer.remat = False
    try:
        trainer.gradients(batch, mask)
        peak_plain = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        peak_plain = None
    trainer.opt.zero_grad(set_to_none=True)
    del trainer, params
    torch.cuda.empty_cache()
    ok = min(accs) >= COPY_ACC and held_acc >= COPY_ACC
    step = sorted(step_s)[len(step_s) // 2]
    log(f"  21c {family} --init finetune, {FINETUNE_STEPS} steps at T "
        f"{LONG_T}, R {LONG_R}, batch {B}: copy accuracy of the steps' "
        f"batches {min(accs):.4f}..{max(accs):.4f}, held-out {held_acc:.4f} "
        f"(nll {held_loss:.4f}; at least {COPY_ACC}); step "
        f"{step * 1e3:.1f} ms (median), {B * LONG_T / step:.0f} tokens/s; "
        f"peak memory of a step {peak_remat / 2**30:.3f} GiB with remat, "
        + (f"{peak_plain / 2**30:.3f} GiB without"
           if peak_plain is not None else "out of memory without")
        + f"; {'ok' if ok else 'FAILED'}")
    return {"batch": B, "accs": accs, "held_acc": held_acc,
            "held_nll": held_loss, "step_ms": step * 1e3,
            "tokens_per_s": B * LONG_T / step, "peak_bytes_remat": peak_remat,
            "peak_bytes_no_remat": peak_plain, "ok": ok}


def self_check_bands(family, path):
    """21d: the tool's self-check bands of a committed checkpoint; every
    band at the trained distances (R <= 2048) at least COPY_ACC, as the JAX
    checkpoint tests hold them."""
    rows = train_tool.self_check(family, path, "cuda")
    ok = all(acc >= COPY_ACC for _, R, _, acc in rows if R <= 2048)
    for T, R, loss, acc in rows:
        log(f"  21d {family} eval T={T:5d} R={R:5d}: nll {loss:.4f} "
            f"(ppl {float(np.exp(loss)):.4f})  copy-acc {acc:.4f}")
    log(f"  21d {family}: bands at R <= 2048 at least {COPY_ACC}: "
        f"{'ok' if ok else 'FAILED'}")
    return {"bands": [{"T": T, "R": R, "nll": loss, "acc": acc}
                      for T, R, loss, acc in rows], "ok": ok}


def phase_training():
    """Phase 21: the quality checkpoints' trainer
    (``lmcache_tpu_torch/tools/train_quality_model.py``) on the card at the
    full quality widths, fp32 with TF32 off: 21a one step against the CPU
    per family, 21b from seed 0, 21c the long finetune per family, 21d the
    self-check bands of both committed checkpoints. Training runs the plain
    attention under autograd, so no hand kernel may launch. Returns (launch
    counts, the numbers)."""
    log("== phase 21: training the quality models on the card (fp32, TF32 "
        "off)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("phase 21: TF32 is on")
    families = (("llama", quality_common.quality_config(),
                 quality_common.CKPT_PATH),
                ("mla", quality_common.quality_mla_config(),
                 quality_common.MLA_CKPT_PATH))
    reset_launch_counts()
    out = {"step_vs_cpu": {f: train_step_against_cpu(f, c, p)
                           for f, c, p in families},
           "from_seed": train_from_seed(),
           "finetune": {f: train_long_finetune(f, c, p)
                        for f, c, p in families},
           "self_check": {f: self_check_bands(f, p) for f, _, p in families}}
    launches = read_launch_counts()
    log(f"  hand kernels launched by training: {launches or 'none'}")
    failed = ([f"21a {f}" for f, r in out["step_vs_cpu"].items()
               if not r["ok"]]
              + ([] if out["from_seed"]["ok"] else ["21b"])
              + [f"21c {f}" for f, r in out["finetune"].items()
                 if not r["ok"]]
              + [f"21d {f}" for f, r in out["self_check"].items()
                 if not r["ok"]]
              + (["a hand kernel launched"] if launches else []))
    if failed:
        raise SystemExit("phase 21: " + ", ".join(failed))
    return {"training": launches}, out


# phase 22: the ranks' launches at full width (22a) and the distributed path
# on a one-rank NCCL group (22b)
TP_CTX, TP_SEG = 16384, 512  # the prefill segment's context and length
TP_DECODE_OFF = [16383, 9000]  # a decode step of two rows
# (name, H, H_kv, D, the "model" sizes): tinyllama-1.1B, Llama-3-8B
TP_GEOMETRIES = (("tinyllama-1.1B", 32, 4, 64, (2, 4)),
                 ("llama-3-8B", 32, 8, 128, (8,)))
TP_MLA_SIZES = (2, 4, 16)  # DeepSeek-V2-Lite's 16 query heads
TP_NEW = 8  # tokens each 22b request decodes
TP_RING_T = 4096  # forward_ring's prompt
TP_BLEND_DOC = 1024  # each of the 22b CacheBlend request's three chunks


def rank_launches(call, args, head_dims, tp):
    """Each of ``tp`` ranks' launch of ``call`` on its contiguous slice of
    every head axis (``head_dims[i]`` the head axis of ``args[i]``, None
    where the argument is whole on every rank), the outputs put back
    together along the output's head axis (2)."""
    from lmcache_tpu_torch.parallel.mesh import take_slice
    outs = []
    for r in range(tp):
        local = [a if d is None else take_slice(a, d, r, tp).contiguous()
                 for a, d in zip(args, head_dims)]
        outs.append(call(*local))
    return torch.cat(outs, dim=2)


def tp_dense_inputs(H, Hkv, D, shape, gen):
    """(bf16 args, int8 args, paged bf16 args, paged int8 args, plain
    references) of rows 1, 3, 4-7 at one shape: the 512-token segment over
    a 16k context, or a decode step; the arenas hold the same K/V as the
    dense pools, page by page."""
    dev = "cuda"
    B, T, q_off = ((1, TP_SEG, [TP_CTX - TP_SEG]) if shape == "prefill"
                   else (2, 1, TP_DECODE_OFF))
    S = TP_CTX
    kv_len = [o + T for o in q_off]
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    kv = torch.randn((2, B, Hkv, S, D), generator=gen, device=dev).bfloat16()
    sym = torch.randint(-127, 128, (2, B, Hkv, S, D), generator=gen,
                        device=dev, dtype=torch.int32).to(torch.int8)
    scale = torch.rand((2, B, S), generator=gen, device=dev) * 0.02 + 0.02
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    NP = S // PAGE
    ids = torch.randperm(B * NP, generator=gen, device=dev) + 1
    table = ids.reshape(B, NP).to(torch.int32).contiguous()

    def arena(x, fill):
        # [B, H, S, D] (or scales [B, S]) onto pages [P, H, page, D]
        P = B * NP + 1
        if x.dim() == 2:
            out = torch.full((P, PAGE), fill, dtype=x.dtype, device=dev)
            out[table.long()] = x.reshape(B, NP, PAGE)
            return out
        out = torch.zeros((P, x.shape[1], PAGE, x.shape[3]), dtype=x.dtype,
                          device=dev)
        out[table.long()] = x.reshape(B, x.shape[1], NP, PAGE,
                                      x.shape[3]).transpose(1, 2)
        return out

    dense = (q, kv[0], kv[1], qo, kl)
    quant = (q, sym[0], sym[1], scale[0], scale[1], qo, kl)
    paged_ = (q, arena(kv[0], 0), arena(kv[1], 0), table, qo, kl)
    paged_q = (q, arena(sym[0], 0), arena(sym[1], 0), arena(scale[0], 1.0),
               arena(scale[1], 1.0), table, qo, kl)
    with uncounted():
        ref = plain_attention(q, kv[0], kv[1], qo, kl)
        kt, vt = sym[0].transpose(1, 2), sym[1].transpose(1, 2)
        ref_q = torch.cat([qa.quantized_attention_reference(
            q[:, t:t + 1024], kt, vt, scale[0], scale[1], qo + t, kl,
            zero_dead_rows=True) for t in range(0, T, 1024)], dim=1)
    return dense, quant, paged_, paged_q, ref, ref_q


def tp_latent_inputs(shape, gen):
    """(dense bf16, dense int8, paged bf16, paged int8) args of rows 8-10
    at DeepSeek-V2-Lite's latent geometry and one shape, and the plain
    references of the bf16 and the int8 latents."""
    dev = "cuda"
    B, T, q_off = ((1, TP_SEG, [TP_CTX - TP_SEG]) if shape == "prefill"
                   else (2, 1, TP_DECODE_OFF))
    S, H, C = TP_CTX, MLA_CFG.n_heads, MLA_C
    kl = torch.tensor([o + T for o in q_off], dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    q = torch.randn((B, T, H, C), generator=gen, device=dev).bfloat16()
    lat = torch.randn((B, S, C), generator=gen, device=dev).bfloat16()
    sym = torch.randint(-127, 128, (B, S, C), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int8)
    scl = torch.rand((B, S), generator=gen, device=dev) * 0.02 + 0.02
    NP = S // PAGE
    ids = torch.randperm(B * NP, generator=gen, device=dev) + 1
    table = ids.reshape(B, NP).to(torch.int32).contiguous()
    P = B * NP + 1
    a_lat = torch.zeros((P, PAGE, MLA_CP), dtype=torch.bfloat16, device=dev)
    a_lat[table.long(), :, :C] = lat.reshape(B, NP, PAGE, C)
    a_sym = torch.zeros((P, PAGE, MLA_CP), dtype=torch.int8, device=dev)
    a_sym[table.long(), :, :C] = sym.reshape(B, NP, PAGE, C)
    a_scl = torch.ones((P, PAGE), device=dev)
    a_scl[table.long()] = scl.reshape(B, NP, PAGE)
    kw = dict(rank=MLA_R, scale=MLA_CFG.sm_scale)
    with uncounted():
        ref = torch.cat([la.latent_attention_reference(
            q[:, t:t + 1024], lat, qo + t, kl, zero_dead_rows=True, **kw)
            for t in range(0, T, 1024)], dim=1)
        ref_q = torch.cat([la.quantized_latent_attention_reference(
            q[:, t:t + 1024], sym, scl, qo + t, kl, zero_dead_rows=True,
            **kw) for t in range(0, T, 1024)], dim=1)
    return ((q, lat, qo, kl), (q, sym, scl, qo, kl),
            (q, a_lat, table, qo, kl), (q, a_sym, a_scl, table, qo, kl),
            ref, ref_q, kw)


def latent_route(name, T, H):
    """The route of a latent launch of T tokens and H heads: row 10 runs
    its key split at T * H <= SPLIT_ROWS rows, rows 8 and 9 their body;
    every body takes (token, head) rows in blocks of 64, token-major."""
    if name.startswith(("paged_latent_attention_dma",
                        "quantized_paged_latent_attention_dma")) \
            and pla.takes_split(T, H):
        return (f"key split of {pla.split_keys(T, H)} keys over {T * H} "
                "rows, then the combine")
    return f"body, {T * H} (token, head) rows, {64 // min(H, 64)} tokens a block"


def phase_parallel_kernels(max_abs):
    """Phase 22a: each rank's launches of rows 1, 3-10 at full width, as
    that rank holds its inputs: contiguous head slices of q and of the
    pools or arenas (kv heads on "model"), the latents whole; the outputs
    put back together along the head axis. Rows 1 and 3-7 must give the
    unsharded launch's bits (heads are independent and each rank keeps the
    query group); rows 8-10 must hold their tolerance against the plain
    version, their route printed per shard. Every launch is held against
    the plain version as phase 2 holds it. Returns the launch counts."""
    log("== phase 22a: the ranks' launches at full width (rows 1, 3-10)")
    gen = torch.Generator(device="cuda").manual_seed(22)
    reset_launch_counts()
    head_axes = {"flash_attention": (2, 1, 1, None, None),
                 "quantized_flash_attention": (2, 1, 1, None, None, None,
                                               None),
                 "paged_attention": (2, 1, 1, None, None, None),
                 "paged_attention_dma": (2, 1, 1, None, None, None),
                 "quantized_paged_attention": (2, 1, 1, None, None, None,
                                               None, None),
                 "quantized_paged_attention_dma": (2, 1, 1, None, None, None,
                                                   None, None)}
    for geo, H, Hkv, D, sizes in TP_GEOMETRIES:
        for shape in ("prefill", "decode"):
            dense, quant, paged_, paged_q, ref, ref_q = tp_dense_inputs(
                H, Hkv, D, shape, gen)
            calls = {
                "flash_attention": (lambda *a: ops.flash_attention(
                    *a, kv_head_major=True), dense, ref),
                "quantized_flash_attention": (
                    lambda *a: qa.quantized_flash_attention(
                        *a, kv_head_major=True), quant, ref_q),
                "paged_attention": (pa.paged_attention, paged_, ref),
                "paged_attention_dma": (pa.paged_attention_dma, paged_, ref),
                "quantized_paged_attention": (pa.quantized_paged_attention,
                                              paged_q, ref_q),
                "quantized_paged_attention_dma": (
                    pa.quantized_paged_attention_dma, paged_q, ref_q)}
            for name, (call, args, plain) in calls.items():
                with uncounted():
                    whole = call(*args)
                for tp in sizes:
                    got = rank_launches(call, args, head_axes[name], tp)
                    case = (f"{geo} {shape}, tp {tp}: {H // tp} heads over "
                            f"{Hkv // tp} kv heads a rank")
                    err = hold_against_plain(name, case, got, plain)
                    max_abs[name] = max(max_abs.get(name, 0.0), err)
                    if not same_bits(got, whole):
                        raise SystemExit(f"{name} at {case}: the ranks' "
                                         "launches differ from the "
                                         "unsharded launch's bits")
                    log(f"    bit-equal to the unsharded launch")
            del dense, quant, paged_, paged_q, ref, ref_q
    H = MLA_CFG.n_heads
    for shape in ("prefill", "decode"):
        (dense, quant, paged_, paged_q, ref, ref_q,
         kw) = tp_latent_inputs(shape, gen)
        T = dense[0].shape[1]
        calls = {
            "latent_flash_attention": (la.latent_flash_attention, dense, ref,
                                       (2, None, None, None)),
            "quantized_latent_flash_attention": (
                la.quantized_latent_flash_attention, quant, ref_q,
                (2, None, None, None, None)),
            "paged_latent_attention": (pla.paged_latent_attention, paged_,
                                       ref, (2, None, None, None, None)),
            "quantized_paged_latent_attention": (
                pla.quantized_paged_latent_attention, paged_q, ref_q,
                (2, None, None, None, None, None)),
            "paged_latent_attention_dma": (pla.paged_latent_attention_dma,
                                           paged_, ref,
                                           (2, None, None, None, None)),
            "quantized_paged_latent_attention_dma": (
                pla.quantized_paged_latent_attention_dma, paged_q, ref_q,
                (2, None, None, None, None, None))}
        for name, (call, args, plain, axes) in calls.items():
            with uncounted():
                whole = call(*args, **kw)
            for tp in TP_MLA_SIZES:
                got = rank_launches(lambda *a: call(*a, **kw), args, axes,
                                    tp)
                case = (f"DeepSeek-V2-Lite {shape}, tp {tp}: {H // tp} heads "
                        f"a rank ({latent_route(name, T, H // tp)}; "
                        f"unsharded: {latent_route(name, T, H)})")
                err = hold_against_plain(name, case, got, plain)
                max_abs[name] = max(max_abs.get(name, 0.0), err)
                log(f"    bit-equal to the unsharded launch: "
                    f"{same_bits(got, whole)}")
        del dense, quant, paged_, paged_q, ref, ref_q
    counts = read_launch_counts()
    log(f"  launches: {counts}")
    return counts


def phase_parallel_engines(cfg, params):
    """Phase 22b: the distributed path on a one-rank NCCL group
    (``init_process_group("nccl")`` through a file store, then
    ``make_mesh(MeshConfig(1, 1), "cuda")``): the dense engine (with a
    "cuda" tier, each prompt served twice: the second time from the tier)
    and the paged engine on tinyllama-1.1B at full width, a CacheBlend
    request on the dense engine (three chunks of ``TP_BLEND_DOC``), both MLA
    engines
    on DeepSeek-V2-Lite at full width cut to 3 layers, each with ``mesh=``
    and ``parallel.shard_params``' parameters, must give the tokens of the
    same engine without a mesh bit for bit; ``forward_ring`` at T 4096 on
    the one-rank ring must agree with ``forward``'s logits by phase 3's
    rule. Returns (launch counts by path, the numbers)."""
    import torch.distributed as dist
    from lmcache_tpu_torch import parallel
    log("== phase 22b: the distributed path on a one-rank NCCL group")
    store = tempfile.mktemp(prefix="lmc-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    launches, out = {}, {}
    try:
        mesh = parallel.make_mesh(parallel.MeshConfig(1, 1), "cuda")
        log(f"  mesh {mesh} over {dist.get_backend()}")
        rng = np.random.default_rng(22)
        prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
                   for n in (1800, 1500, 900, 2000)]
        sp = SamplingParams(max_new_tokens=TP_NEW)

        def tier(name):
            return LMCacheEngine(
                LMCacheEngineConfig(local_device="cuda", chunk_size=256),
                parallel.mesh.shard_metadata(LMCacheEngineMetadata(
                    model_name=name, world_size=1, worker_id=0, fmt="vllm",
                    dtype="bfloat16"), mesh))

        def serve(make, ps, twice=False):
            eng = make()
            reqs = eng.generate(ps, sp)
            toks = [r.output_tokens for r in reqs]
            if twice:
                eng.cache_engine.engine_.flush()
                again = eng.generate(ps, sp)
                toks += [r.output_tokens for r in again]
                out.setdefault("cached_prefix_len", []).extend(
                    r.cached_prefix_len for r in again)
            return toks

        dense_seq = 2048 + 64
        sharded = parallel.shard_params(params, mesh)
        runs = (
            ("dense", lambda m, p, t: ServingEngine(
                cfg, p, max_batch=4, max_seq=dense_seq, mesh=m,
                cache_engine=t), True),
            ("paged", lambda m, p, t: PagedServingEngine(
                cfg, p, max_batch=4, max_seq=dense_seq, num_pages=160,
                page_size=PAGE, mesh=m), False))
        for name, make, twice in runs:
            with uncounted():
                want = serve(lambda: make(None, params, tier(
                    f"tp-plain-{name}")), prompts, twice)
            reset_launch_counts()
            got = serve(lambda: make(mesh, sharded, tier(
                f"tp-mesh-{name}")), prompts, twice)
            torch.cuda.synchronize()
            launches[f"parallel {name} tinyllama"] = read_launch_counts()
            log(f"  {name} engine, tinyllama-1.1B: tokens with the mesh "
                f"{'==' if got == want else '!='} without "
                f"({len(got)} requests, {TP_NEW} tokens each)")
            if got != want:
                raise SystemExit(f"phase 22b: the {name} engine's tokens "
                                 "differ with a mesh")
        hits = out.get("cached_prefix_len", [])
        log(f"  dense engine's second pass: cached prefixes {hits}")
        if not all(h > 0 for h in hits):
            raise SystemExit("phase 22b: the second pass missed the tier")

        # a CacheBlend request: the chunk prefills and the heal on the mesh
        docs = [np.random.default_rng(23).integers(
            0, cfg.vocab_size, (3, TP_BLEND_DOC), dtype=np.int32)[i]
            for i in range(3)]

        def blend(m, p, t):
            eng = ServingEngine(cfg, p, max_batch=1,
                                max_seq=3 * TP_BLEND_DOC + 64, mesh=m,
                                cache_engine=t)
            req = Request(np.empty(0, np.int32), sp, context_chunks=docs)
            eng.add_request(req)
            eng.run()
            return req.output_tokens

        with uncounted():
            want = blend(None, params, tier("tp-plain-blend"))
        reset_launch_counts()
        got = blend(mesh, sharded, tier("tp-mesh-blend"))
        torch.cuda.synchronize()
        launches["parallel blend tinyllama"] = read_launch_counts()
        log(f"  CacheBlend request, 3 x {TP_BLEND_DOC} tokens: tokens with "
            f"the mesh {'==' if got == want else '!='} without")
        if got != want:
            raise SystemExit("phase 22b: the blend request's tokens differ "
                             "with a mesh")

        mcfg = dataclasses.replace(MLA_CFG, n_layers=MLA_CHECKPOINT_LAYERS)
        free_device_memory()
        mparams = mla.init_params(
            mcfg, generator=torch.Generator(device="cuda").manual_seed(0))
        msharded = parallel.shard_params(mparams, mesh)
        mprompts = prompts[:2]
        for name, make in (
                ("mla", lambda m, p: MLAServingEngine(
                    mcfg, p, max_batch=2, max_seq=dense_seq, mesh=m)),
                ("mla paged", lambda m, p: MLAPagedServingEngine(
                    mcfg, p, max_batch=2, max_seq=dense_seq, num_pages=80,
                    page_size=PAGE, mesh=m))):
            with uncounted():
                want = serve(lambda: make(None, mparams), mprompts)
            reset_launch_counts()
            got = serve(lambda: make(mesh, msharded), mprompts)
            torch.cuda.synchronize()
            launches[f"parallel {name} v2-lite"] = read_launch_counts()
            log(f"  {name} engine, DeepSeek-V2-Lite at "
                f"{MLA_CHECKPOINT_LAYERS} layers: tokens with the mesh "
                f"{'==' if got == want else '!='} without")
            if got != want:
                raise SystemExit(f"phase 22b: the {name} engine's tokens "
                                 "differ with a mesh")
        del mparams, msharded
        free_device_memory()

        tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, TP_RING_T, dtype=np.int32),
            device="cuda").long()[None]
        reset_launch_counts()
        t0 = time.perf_counter()
        ring_logits, ring_cache = llama.forward_ring(sharded, cfg, tokens,
                                                     mesh)
        torch.cuda.synchronize()
        out["forward_ring_s"] = time.perf_counter() - t0
        launches["parallel forward_ring"] = read_launch_counts()
        with uncounted():
            cache = llama.new_kv_cache(cfg, 1, TP_RING_T)
            logits, _ = llama.forward(params, cfg, tokens, torch.zeros(
                1, dtype=torch.int32, device="cuda"), cache)
        whole_rel = ((ring_logits - logits).norm() / logits.norm()).item()
        cache_rel = ((ring_cache.float() - cache.float()).norm()
                     / cache.float().norm()).item()
        out["forward_ring_rel_l2"] = whole_rel
        log(f"  forward_ring, T {TP_RING_T} on the one-rank ring: "
            f"{out['forward_ring_s']:.2f} s; logits rel_l2 over every "
            f"position {whole_rel:.3e}, cache rel_l2 {cache_rel:.3e}")
        if not (_logits_agree("forward_ring vs forward, last token",
                              [ring_logits[0, -1]], [logits[0, -1]])
                and whole_rel <= REL_L2_REUSE and cache_rel <= REL_L2_REUSE):
            raise SystemExit("phase 22b: forward_ring disagrees with "
                             "forward")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    log("  NCCL across several ranks was not run: this machine has one GPU "
        f"({torch.cuda.device_count()} visible); the multi-rank logic is "
        "held on the CPU under gloo (tests/test_torch_parallel.py) and "
        "run on four cards by lmcache_tpu_torch/tools/mesh_check.py")
    return launches, out


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
    # one cache server for phases 9, 10e and 20, started while phase 1
    # builds
    server, url = start_cache_server(wait=False)
    try:
        return run_phases(card, server, url)
    finally:
        stop_process(server)


@contextmanager
def phase_clock(name, seconds):
    """Time the phase run while entered (to a synchronize) into
    ``seconds[name]`` and print it on a line of its own."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    log(f"phase {name}: {seconds[name]:.1f} s")


def run_phases(card, server, url):
    seconds = {}
    log("== phase 1: build")
    with phase_clock("1", seconds):
        t0 = time.perf_counter()
        libs = _build.build()
        log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if any(w in line for w in ("registers", "spill", "error",
                                           "wgmma")):
                    log(f"  nvcc {name}: {line.strip()}")
        sass = sass_counts(libs)
        int8_paged = int8_paged_report(sass)
        paged_softcap = paged_softcap_report(sass)
        variant_build = variant_report(sass)

    with phase_clock("2", seconds):
        max_abs = phase_kernels()
    launches = {}
    with phase_clock("11", seconds):
        ablation_launches, ablation_rows, ablation_worst, ablation = (
            phase_ablation())
    launches.update(ablation_launches)
    max_abs.update(ablation_worst)

    cfg = llama.LlamaConfig.tinyllama_1_1b()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))

    # every path is driven with the counts at 0 and read just after
    with phase_clock("3", seconds):
        reset_launch_counts()
        ttft = phase_main_path(cfg, params)
        launches["main_path"] = read_launch_counts()
    phase3_logits = ttft.pop("full_logits")
    with phase_clock("4", seconds):
        reset_launch_counts()
        prompts, dense_logits = phase_serving(cfg, params)
        launches["serving"] = read_launch_counts()
    with phase_clock("5", seconds):
        paged_launches, decode_profiles = phase_paged_tinyllama(
            cfg, params, prompts, dense_logits)
    launches.update(paged_launches)
    with phase_clock("6c", seconds):
        int8_launches, int8_bench, dense_decode_profiles = phase_int8_dense(
            cfg, params, prompts, dense_logits)
    launches.update(int8_launches)
    with phase_clock("6e", seconds):
        stream_launches, stream_ttft = phase_streamed_prefill(cfg, params)
    launches.update(stream_launches)
    await_cache_server(server, url)
    with phase_clock("9", seconds):
        remote_launches, remote = phase_remote(cfg, params,
                                               ttft["ttft_full_ms"], url)
    launches.update(remote_launches)
    del dense_logits
    torch.cuda.empty_cache()
    with phase_clock("12a", seconds):
        blend_launches, blend_out = phase_blend(
            cfg, params, False,
            engines=[(ServingEngine, {}),
                     (ServingEngine, {"kv_dtype": "int8"}),
                     (PagedServingEngine, {"page_size": PAGE,
                                           "num_pages": NP_BLEND})])
    launches.update(blend_launches)
    with phase_clock("14", seconds):
        decode_launches, decode_out = phase_decode_options(cfg, params)
    launches.update(decode_launches)
    with phase_clock("16", seconds):
        tier_launches, tier_out = phase_tiers(cfg, params)
    launches.update(tier_launches)
    with phase_clock("17", seconds):
        ckpt_launches, ckpt_out, loaded = phase_checkpoints(cfg, params,
                                                            phase3_logits)
    launches.update(ckpt_launches)
    with phase_clock("18", seconds):
        http_launches, http_out = phase_http(cfg, loaded)
    launches.update(http_launches)
    with phase_clock("19", seconds):
        hook_launches, hook_out = phase_hooks(cfg, loaded)
    launches.update(hook_launches)
    with phase_clock("22", seconds):
        launches["parallel kernels"] = phase_parallel_kernels(max_abs)
        tp_launches, tp_out = phase_parallel_engines(cfg, params)
    launches.update(tp_launches)
    del loaded, phase3_logits, params
    torch.cuda.empty_cache()
    with phase_clock("20", seconds):
        example_launches, example_out = phase_examples(url)
    launches.update(example_launches)
    with phase_clock("21", seconds):
        train_launches, train_out = phase_training()
    launches.update(train_launches)
    torch.cuda.empty_cache()
    with phase_clock("15", seconds):
        quality_launches, quality_out = phase_quality()
    launches.update(quality_launches)
    torch.cuda.empty_cache()
    with phase_clock("9b", seconds):
        remote["codec_throughput"] = phase_codec_throughput()
    torch.cuda.empty_cache()
    with phase_clock("6", seconds):
        phi3_launches, phi3_profiles = phase_paged_phi3()
    launches.update(phi3_launches)
    with phase_clock("6d", seconds):
        mistral_launches, mistral_profiles = phase_mistral()
    launches.update(mistral_launches)
    torch.cuda.empty_cache()
    with phase_clock("10", seconds):
        mla_launches, mla_out = phase_mla(remote["store"]["wire_bytes"], url)
    launches.update(mla_launches)
    torch.cuda.empty_cache()
    with phase_clock("13b", seconds):
        qwen_launches, qwen_out = phase_qwen3_moe()
    launches.update(qwen_launches)
    with phase_clock("13a", seconds):
        preset_launches, preset_out = phase_presets()
    launches.update(preset_launches)
    with phase_clock("13c", seconds):
        gemma2_launches, gemma2_profiles = phase_gemma2()
    launches.update(gemma2_launches)
    reset_launch_counts()

    log("== phase 7: launch counts")
    for phase, counts in launches.items():
        log(f"  {phase}: {counts}")
    expected = {
        "main_path": ("flash_attention", ("prefill",)),
        "serving": [("flash_attention", ("prefill", "decode")),
                    ("combine_partials", ("decode",))],
        "paged tinyllama bf16": [("paged_attention_dma",
                                  ("prefill", "decode")),
                                 ("combine_partials", ("decode",))],
        "paged tinyllama int8": [("quantized_paged_attention_dma",
                                  ("prefill", "decode")),
                                 ("combine_partials", ("decode",))],
        "paged phi3 bf16": [("paged_attention",
                             ("prefill+window", "decode+window")),
                            ("combine_partials", ("decode",))],
        "paged phi3 int8": [("quantized_paged_attention",
                             ("prefill+window", "decode+window")),
                            ("combine_partials", ("decode",))],
        "int8 dense bench": ("quantized_flash_attention", ("prefill",)),
        "int8 dense serving": [("quantized_flash_attention",
                                ("prefill", "decode")),
                               ("combine_partials", ("decode",))],
        "streamed prefill": ("flash_attention_dma", ("prefill",)),
        "mistral native": ("flash_attention",
                           ("prefill+window", "decode+window")),
        "mistral int8": [("quantized_flash_attention",
                          ("prefill+window", "decode+window")),
                         ("combine_partials", ("decode",))],
        "remote store": [("range_encode", ("store",)),
                         ("range_encode_compact", ("store",))],
        "remote reuse": [("range_decode", ("retrieve",)),
                         ("range_encode", ("store",)),
                         ("range_encode_compact", ("store",)),
                         ("flash_attention", ("prefill",))],
        "remote paged": [("range_decode", ("retrieve",)),
                         ("paged_attention_dma", ("prefill",))],
        "mla bench": ("latent_flash_attention", ("prefill",)),
        "mla serving native": ("latent_flash_attention",
                               ("prefill", "decode")),
        "mla serving int8": ("quantized_latent_flash_attention",
                             ("prefill", "decode")),
        "mla paged bf16": [("paged_latent_attention_dma",
                            ("prefill", "decode")),
                           ("latent_combine_partials", ("decode",))],
        "mla paged int8": [("quantized_paged_latent_attention_dma",
                            ("prefill", "decode")),
                           ("latent_combine_partials", ("decode",))],
        "mla row 9": [("paged_latent_attention", ("prefill",)),
                      ("quantized_paged_latent_attention", ("prefill",))],
        "mla remote": [("range_encode", ("store",)),
                       ("range_encode_compact", ("store",)),
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
        "dense blend PagedServingEngine native": [
            ("paged_attention_dma", ("decode",)),
            ("combine_partials", ("decode",))],
        "mla blend store": ("latent_flash_attention", ("prefill",)),
        "mla blend MLAServingEngine native": ("latent_flash_attention",
                                              ("decode",)),
        "mla blend MLAPagedServingEngine native": (
            "paged_latent_attention_dma", ("decode",)),
        "qwen3-moe bench": ("flash_attention", ("prefill",)),
        "qwen3-moe serving native": [("flash_attention",
                                      ("prefill", "decode")),
                                     ("combine_partials", ("decode",))],
        "qwen3-moe serving int8": [("quantized_flash_attention",
                                    ("prefill", "decode")),
                                   ("combine_partials", ("decode",))],
        "qwen3-moe paged bf16": [("paged_attention_dma",
                                  ("prefill", "decode")),
                                 ("combine_partials", ("decode",))],
        "qwen3-moe paged int8": [("quantized_paged_attention_dma",
                                  ("prefill", "decode")),
                                 ("combine_partials", ("decode",))],
    }
    expected["remote reuse python"] = expected["remote reuse"]
    expected["quality gate"] = [
        ("flash_attention", ("prefill",)),
        ("latent_flash_attention", ("prefill",)),
        ("range_encode", ("store",)), ("range_encode_compact", ("store",)),
        ("range_decode", ("retrieve",))]
    expected["disk reuse"] = ("flash_attention", ("prefill",))
    expected["hybrid prefetch"] = [("range_decode", ("retrieve",)),
                                   ("flash_attention", ("prefill",))]
    expected["hybrid fill"] = expected["hybrid prefetch"]
    expected["checkpoint tinyllama"] = [("flash_attention",
                                         ("prefill", "decode")),
                                        ("combine_partials", ("decode",))]
    expected["checkpoint v2-lite"] = ("latent_flash_attention",
                                      ("prefill", "decode"))
    expected["http"] = expected["checkpoint tinyllama"]
    expected["hooks store"] = ("flash_attention", ("prefill",))
    expected["hooks"] = ("flash_attention", ("prefill",))
    both = ("prefill", "decode")
    for name, kernel, combine in (
            ("tinyllama dense native", "flash_attention", "combine_partials"),
            ("tinyllama dense int8", "quantized_flash_attention",
             "combine_partials"),
            ("tinyllama paged bf16", "paged_attention_dma",
             "combine_partials"),
            ("tinyllama paged int8", "quantized_paged_attention_dma",
             "combine_partials"),
            ("v2-lite MLA dense", "latent_flash_attention", None),
            ("v2-lite MLA paged", "paged_latent_attention_dma",
             "latent_combine_partials")):
        expected[f"decode options {name}"] = [(kernel, both)] + (
            [(combine, ("decode",))] if combine else [])
    gemma2 = llama.LlamaConfig.gemma2_9b()
    for arena, kernel in (("bf16", "paged_attention_dma"),
                          ("int8", "quantized_paged_attention_dma")):
        expected[f"paged gemma2 {arena}"] = [
            (kernel, expected_kinds(gemma2, "prefill")
             + expected_kinds(gemma2, "decode")),
            ("combine_partials", ("decode",))]
    for name in NEW_PRESETS:
        cfg = preset_at_depth(name)
        kinds = (expected_kinds(cfg, "prefill")
                 + expected_kinds(cfg, "decode"))
        expected[f"preset {name}"] = [
            (k, kinds) for k in ("flash_attention",
                                 "quantized_flash_attention",
                                 "paged_attention_dma",
                                 "quantized_paged_attention_dma")] + [
            ("combine_partials", ("decode",))]
    dense_serving = expected["checkpoint tinyllama"]
    for name in ("offline_inference", "save_decode_cache", "online_session",
                 "share_across_instances", "disaggregated_prefill",
                 "speculative_decode"):
        expected[f"example {name}"] = dense_serving
    expected["example storage_backends"] = [("range_encode", ("store",)),
                                            ("range_decode", ("retrieve",))]
    expected["example rag_blend"] = ("flash_attention", ("prefill",))
    expected["example mla_latent_cache"] = ("latent_flash_attention",
                                            ("prefill", "decode"))
    expected["parallel kernels"] = [
        (k, both) for k in (
            "flash_attention", "quantized_flash_attention",
            "paged_attention", "quantized_paged_attention",
            "paged_attention_dma", "quantized_paged_attention_dma",
            "latent_flash_attention", "quantized_latent_flash_attention",
            "paged_latent_attention", "quantized_paged_latent_attention",
            "paged_latent_attention_dma",
            "quantized_paged_latent_attention_dma")] + [
        ("combine_partials", ("decode",)),
        ("latent_combine_partials", ("decode",))]
    expected["parallel dense tinyllama"] = dense_serving
    expected["parallel paged tinyllama"] = [
        ("paged_attention_dma", both), ("combine_partials", ("decode",))]
    expected["parallel blend tinyllama"] = [
        ("flash_attention", ("prefill", "decode"))]
    expected["parallel mla v2-lite"] = ("latent_flash_attention", both)
    expected["parallel mla paged v2-lite"] = [
        ("paged_latent_attention_dma", both),
        ("latent_combine_partials", ("decode",))]
    for phase, wanted in expected.items():
        for kernel, kinds in (wanted if isinstance(wanted, list)
                              else [wanted]):
            for kind in kinds:
                if launches[phase].get(kernel, {}).get(kind, 0) <= 0:
                    raise SystemExit(f"{kernel}: no {kind} launch in {phase}")

    if launches["training"]:
        raise SystemExit(f"training launched {launches['training']}")
    if launches["parallel forward_ring"]:
        raise SystemExit("forward_ring's plain ring attention launched "
                         f"{launches['parallel forward_ring']}")

    with phase_clock("8", seconds):
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
              "phi3_paged_profiles": phi3_profiles,
              "dense_decode_profiles": dense_decode_profiles,
              "mistral_profiles": mistral_profiles, "mla": mla_out,
              "qwen3_moe": qwen_out, "presets": preset_out,
              "gemma2_paged_profiles": gemma2_profiles,
              "ablation": ablation, "blend": blend_out,
              "decode_options": decode_out, "quality": quality_out,
              "tiers": tier_out, "checkpoints": ckpt_out, "http": http_out,
              "hooks": hook_out, "examples": example_out,
              "training": train_out, "parallel": tp_out,
              "phase_seconds": seconds,
              "int8_paged_build": int8_paged,
              "paged_softcap_build": paged_softcap,
              "variant_build": variant_build, "card": card}
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items()))
    log(card)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
