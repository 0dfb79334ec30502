"""The port's parallelism across several ranks: one process a card, NCCL.

    python -m lmcache_tpu_torch.tools.mesh_check [--ranks 4] [--out DIR]
    python -m lmcache_tpu_torch.tools.mesh_check --device cpu --small

The parent builds every kernel once (``ops._build.build``: one ``nvcc`` a
source, all at once), then starts one process a rank. Each binds to card
``rank`` (``torch.cuda.set_device``), joins an NCCL group of ``--ranks``
ranks through a file store and runs, on the ``("data", "model")`` meshes
(1, R) and (2, R / 2):

1. the dense engine with a per-shard ``"cuda"`` tier (each prompt served
   twice, the second pass from the tier) and the paged engine on
   tinyllama-1.1B at full width and depth, random weights from seed 0; the
   MLA engine on DeepSeek-V2-Lite at full width cut to 3 layers at (1, R);
2. ``ring_attention`` at (R, 1) and (2, R / 2) on fp32 inputs, and
   ``llama.forward_ring`` on tinyllama at (R, 1), T 4096;
3. one prefill of the first prompt with each mesh and without, both
   models: the logits' relative L2 distance and the share of positions
   whose top token differs;
4. a batched decode step of tinyllama (4 rows at a 2048-token context)
   with the mesh, timed with CUDA events, beside the same step without a
   mesh on one card.

Gates (the process exits 1 where one fails):

- every rank samples the same tokens (all-gathered);
- each token of a mesh engine is the greedy choice of the model without a
  mesh, decided as ``chip_smoke.py`` phase 5 decides two first tokens:
  against the fp32-headed witness, one forward without a mesh over the
  prompt and the engine's tokens with the plain attention (fp32 inside)
  and the final norm and LM head in fp32 (the engines round both to
  bf16). A token that differs from the witness's greedy choice passes
  where the witness puts the two tokens' logits at most ``TIE_STEPS`` = 1
  bf16 step apart, the step taken at the larger of their magnitudes, or
  at most as far apart as the same engine without a mesh puts its own
  tokens in that unit, where that is larger (the control: its chunked
  prefill, its decode steps and MoE routing near ties). The sums over
  "model" add the ranks' bf16 partial products in fp32, in another order
  than one product does, so the tokens need not equal the engine's
  without a mesh bit for bit; how many do is reported, and how far, in
  the same unit, the mesh engine's tokens and the one-card engine's lie
  from one bf16 forward with the mesh;
- the second pass retrieves a prefix from the tier;
- where a request's tokens first differ from the one-card engine's, both
  engines' gaps between their top two logprobs at that step are reported
  (a flipped near tie shows small gaps on both sides);
- a prefill's logits with a mesh within a relative L2 distance of 5e-2
  of those without;
- ring attention within 1e-4 of the plain attention; ``forward_ring``'s
  logits within a relative L2 distance of 5e-2 of ``forward``'s and its
  last token the greedy choice as above.

Each rank writes ``rank<R>.json`` into ``--out``; the parent prints one JSON
line: the card's name and power limit, each case's tokens, gates and times.
``--device cpu --small`` runs the same over gloo on small models, where the
kernels' plain versions run (no card needed).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.cache_engine import LMCacheEngine
from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.ops.attention import mha_reference
from lmcache_tpu_torch.ops.latent_attention import latent_attention_reference
from lmcache_tpu_torch.parallel import (MeshConfig, make_mesh,
                                        ring_attention, shard_params)
from lmcache_tpu_torch.parallel.mesh import shard_metadata
from lmcache_tpu_torch.serving import (MLAServingEngine, PagedServingEngine,
                                       SamplingParams, ServingEngine)
from lmcache_tpu_torch.utils import resolve_device

NEW_TOKENS = 8
RING_T = 4096
DECODE_ROWS, DECODE_CTX = 4, 2048
RING_ATOL = 1e-4
REL_L2 = 5e-2
TIE_STEPS = 1.0
JOIN_SECONDS = 420


def models(small, dev):
    """(llama config, params, MLA config, params, prompt lengths, chunk,
    page): full width on the card, small on the CPU."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if small:
        cfg = llama.LlamaConfig.tiny(n_layers=2, n_heads=8, n_kv_heads=4,
                                     dim=256, hidden_dim=256)
        mcfg = mla.MLAConfig.tiny(n_layers=2, n_routed_experts=4,
                                  n_shared_experts=1, n_experts_per_tok=2,
                                  moe_hidden_dim=64, first_k_dense_replace=1)
        lengths, chunk, page = (40, 33, 21, 47), 16, 16
    else:
        cfg = llama.LlamaConfig.tinyllama_1_1b()
        mcfg = dataclasses.replace(mla.MLAConfig.deepseek_v2_lite(),
                                   n_layers=3)
        lengths, chunk, page = (1800, 1500, 900, 2000), 256, 64
    params = llama.init_params(cfg, gen, device=dev)
    mparams = mla.init_params(mcfg, gen, device=dev)
    return cfg, params, mcfg, mparams, lengths, chunk, page


_MESHES = {}


def mesh_of(shape, dev):
    """One mesh a shape for the whole run (each makes its groups)."""
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(MeshConfig(*shape), dev.type)
    return _MESHES[shape]


def agree(name, value):
    """Every rank's ``value`` (a list of token lists); raises where they
    differ."""
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, value)
    if any(v != value for v in everyone):
        raise AssertionError(f"{name}: the ranks disagree: {everyone}")


def _bf16_step(x):
    """The spacing of bf16 values at the magnitude of ``x`` (fp32): 8
    significand bits, so 2 ** (floor(log2 |x|) - 7)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _head32(x, params, cfg):
    """The final norm and the LM head in fp32, with a final softcap."""
    x32 = x.float()
    h = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + cfg.norm_eps)
    w = params["final_norm"].float()
    h = h * (1.0 + w) if getattr(cfg, "norm_one_offset", False) else h * w
    logits = h @ params["lm_head"].float()
    cap = getattr(cfg, "final_logit_softcap", None)
    return logits if cap is None else cap * torch.tanh(logits / cap)


@contextlib.contextmanager
def _fp32_witness(module):
    """``module.forward`` as the fp32-headed witness: the final norm and
    LM head of :func:`_head32`; MLA's latent attention plain (the dense
    forward takes ``use_kernel=False``)."""
    if module is mla:
        saved = mla.latent_flash_attention, mla._logits
        mla.latent_flash_attention = latent_attention_reference
        mla._logits = lambda x, p, c, last: _head32(
            x[:, -1:] if last else x, p, c)
    else:
        saved = llama._lm_logits
        llama._lm_logits = _head32
    try:
        yield
    finally:
        if module is mla:
            mla.latent_flash_attention, mla._logits = saved
        else:
            llama._lm_logits = saved


def greedy_margin(module, cfg, params, prompt, tokens, dev, mesh=None):
    """How far ``tokens`` lie from the greedy choices of one forward over
    ``prompt`` and the tokens: at each token, its row's top logit minus its
    own in bf16 steps at the larger of the two magnitudes; the largest (0
    where every token is its row's greedy choice). Without a mesh the
    forward is the fp32-headed witness (:func:`_fp32_witness`); with
    ``mesh`` it is the forward with the mesh and this rank's ``params``."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    new = (mla.new_latent_cache if module is mla else llama.new_kv_cache)
    cache = new(cfg, 1, len(seq), device=dev, mesh=mesh)
    args = (params, cfg, torch.as_tensor(seq, device=dev).long()[None],
            torch.zeros(1, dtype=torch.int32, device=dev), cache)
    if mesh is not None:
        logits, _ = module.forward(*args, mesh=mesh)
    else:
        with _fp32_witness(module):
            logits, _ = module.forward(*args, **(
                {} if module is mla else {"use_kernel": False}))
    rows = logits[0, len(prompt) - 1:].float()
    top = rows.max(dim=-1).values
    picked = rows[torch.arange(len(tokens)), torch.as_tensor(tokens)]
    step = _bf16_step(torch.maximum(top.abs(), picked.abs()))
    return float(((top - picked) / step).max())


def top_gaps(req):
    """The logprob of each step's pick minus that of the runner-up: how
    wide a margin the engine's own logits gave it."""
    return [lp["top"][0][1] - lp["top"][1][1] for lp in req.logprobs]


def first_difference(toks, plain_toks, gaps, plain_gaps):
    """Where a request's tokens first differ from the engine's without a
    mesh: (request, step, the two tokens, both engines' top-two gaps at
    that step), one a differing request."""
    out = []
    for i, (a, b) in enumerate(zip(toks, plain_toks)):
        steps = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if steps:
            j = steps[0]
            out.append({"request": i, "step": j, "tokens": [a[j], b[j]],
                        "gap": gaps[i][j], "no_mesh_gap": plain_gaps[i][j]})
    return out


def forward_agreement(module, cfg, params, mesh, prompt, dev):
    """One prefill of ``prompt`` with ``mesh`` and without: the logits'
    relative L2 distance over every position and the share of positions
    whose top token differs."""
    tokens = torch.as_tensor(prompt, device=dev).long()[None]
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    new = (mla.new_latent_cache if module is mla else llama.new_kv_cache)
    got, _ = module.forward(shard_params(params, mesh), cfg, tokens, start,
                            new(cfg, 1, len(prompt), device=dev, mesh=mesh),
                            mesh=mesh)
    want, _ = module.forward(params, cfg, tokens, start,
                             new(cfg, 1, len(prompt), device=dev))
    rel = ((got - want).norm() / want.norm()).item()
    flips = (got.argmax(-1) != want.argmax(-1)).float().mean().item()
    return {"rel_l2": rel, "top1_differs": flips, "ok": rel <= REL_L2}


def run_engines(args, dev, out):
    cfg, params, mcfg, mparams, lengths, chunk, page = models(args.small, dev)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in lengths]
    # the top two logprobs of each step: how near a tie each pick was
    sp = SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=2)
    R = dist.get_world_size()
    seq = max(lengths) + 2 * NEW_TOKENS + page

    def tier(name, mesh):
        meta = LMCacheEngineMetadata(model_name=name, world_size=1,
                                     worker_id=0, fmt="vllm",
                                     dtype=str(llama.torch_dtype(cfg))[6:])
        return LMCacheEngine(LMCacheEngineConfig(local_device=dev.type,
                                                 chunk_size=chunk),
                             shard_metadata(meta, mesh))

    makers = {
        "dense": lambda c, p, m, t: ServingEngine(
            c, p, max_batch=4, max_seq=seq, mesh=m, cache_engine=t,
            device=dev),
        "paged": lambda c, p, m, t: PagedServingEngine(
            c, p, max_batch=4, max_seq=seq, num_pages=4 * seq // page + 8,
            page_size=page, mesh=m, device=dev),
        "mla": lambda c, p, m, t: MLAServingEngine(
            c, p, max_batch=2, max_seq=seq, mesh=m, device=dev),
    }
    cases = [("dense", (1, R)), ("dense", (2, R // 2)), ("paged", (1, R)),
             ("paged", (2, R // 2)), ("mla", (1, R))]
    for name, module, c, p, shape in (
            ("llama", llama, cfg, params, (1, R)),
            ("llama", llama, cfg, params, (2, R // 2)),
            ("mla", mla, mcfg, mparams, (1, R))):
        out[f"{name} prefill {shape[0]}x{shape[1]}"] = forward_agreement(
            module, c, p, mesh_of(shape, dev), prompts[0], dev)
    plain = {}
    for kind, shape in cases:
        c, p, module = ((mcfg, mparams, mla) if kind == "mla"
                        else (cfg, params, llama))
        ps = prompts[:2] if kind == "mla" else prompts
        if kind not in plain:
            eng = makers[kind](c, p, None, None)
            reqs = eng.generate(ps, sp)
            toks = [r.output_tokens for r in reqs]
            # the control: how far the engine without a mesh lies from one
            # forward (its chunked prefill and decode steps, MoE routing
            # near ties)
            plain[kind] = (toks, max(greedy_margin(module, c, p, q, x, dev)
                                     for q, x in zip(ps, toks)),
                           [top_gaps(r) for r in reqs])
            del eng
        plain_toks, plain_margin, plain_gaps = plain[kind]
        mesh = mesh_of(shape, dev)
        name = f"{kind} {shape[0]}x{shape[1]}"
        t = tier(f"mesh-{name}", mesh) if kind == "dense" else None
        local = shard_params(p, mesh)
        eng = makers[kind](c, local, mesh, t)
        _sync(dev)
        t0 = time.perf_counter()
        reqs = eng.generate(ps, sp)
        _sync(dev)
        toks = [r.output_tokens for r in reqs]
        res = {"tokens": toks, "seconds": time.perf_counter() - t0,
               "equal_to_no_mesh": sum(a == b for a, b in
                                       zip(toks, plain_toks)),
               "no_mesh_margin_steps": plain_margin,
               "first_difference": first_difference(
                   toks, plain_toks, [top_gaps(r) for r in reqs],
                   plain_gaps)}
        agree(name, toks)
        margins = [greedy_margin(module, c, p, q, x, dev)
                   for q, x in zip(ps, toks)]
        # against one forward with the mesh: the engine's own tokens (its
        # scheduler on the mesh) and, the other way round, those of the
        # engine without a mesh (a near tie is narrow from both sides)
        res["mesh_tokens_under_mesh_steps"] = max(
            greedy_margin(module, c, local, q, x, dev, mesh)
            for q, x in zip(ps, toks))
        res["no_mesh_tokens_under_mesh_steps"] = max(
            greedy_margin(module, c, local, q, x, dev, mesh)
            for q, x in zip(ps, plain_toks))
        if t is not None:
            t.engine_.flush()
            again = eng.generate(ps, sp)
            res["second_cached"] = [r.cached_prefix_len for r in again]
            margins += [greedy_margin(module, c, p, q, r.output_tokens, dev)
                        for q, r in zip(ps, again)]
            agree(name + " again", [r.output_tokens for r in again])
            t.close()
        res["margin_steps"] = max(margins)
        res["ok"] = (res["margin_steps"] <= max(TIE_STEPS, plain_margin)
                     and all(n > 0 for n in res.get("second_cached", [1])))
        out[name] = res
        del eng
    return cfg, params


def run_rings(cfg, params, dev, small, out):
    R = dist.get_world_size()
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, Hkv, G, D = 2, (64 if small else RING_T), 4, 2, 64
    q = torch.randn((B, T, Hkv * G, D), generator=gen, device=dev)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev)
    offs = torch.zeros(B, dtype=torch.int32, device=dev)
    kvl = torch.tensor([T, T - 100 if not small else T - 14],
                       dtype=torch.int32, device=dev)
    ref = mha_reference(q, k, v, offs, kvl)
    for shape in ((R, 1), (2, R // 2)):
        mesh = mesh_of(shape, dev)
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        got = ring_attention(q, k, v, offs, kvl, mesh)
        Tl, Hl = T // shape[0], Hkv * G // shape[1]
        want = ref[:, d * Tl:(d + 1) * Tl, m * Hl:(m + 1) * Hl]
        err = (got - want).abs().max().item()
        out[f"ring_attention {shape[0]}x{shape[1]}"] = {
            "max_abs_err": err, "ok": err <= RING_ATOL}
    mesh = mesh_of((R, 1), dev)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, T), dtype=np.int32), device=dev).long()
    _sync(dev)
    t0 = time.perf_counter()
    logits, _ = llama.forward_ring(shard_params(params, mesh), cfg, tokens,
                                   mesh)
    _sync(dev)
    ring_s = time.perf_counter() - t0
    whole, _ = llama.forward(params, cfg, tokens,
                             torch.zeros(1, dtype=torch.int32, device=dev),
                             llama.new_kv_cache(cfg, 1, T, device=dev))
    d = mesh.get_local_rank("data")
    Tl = T // R
    want = whole[:, d * Tl:(d + 1) * Tl].float()
    rel = ((logits.float() - want).norm() / want.norm()).item()
    top = want[0, -1].max()
    pick_ok = bool(want[0, -1, int(logits[0, -1].argmax())]
                   >= top - top.abs() * 2.0**-7)
    out[f"forward_ring {R}x1"] = {
        "rel_l2": rel, "seconds": ring_s,
        "ok": rel <= REL_L2 and (d != R - 1 or pick_ok)}


def time_decode(cfg, params, dev, out):
    """One batched decode step of DECODE_ROWS rows at DECODE_CTX, with the
    mesh and without, device time by CUDA events (host time on the CPU)."""
    R = dist.get_world_size()
    S = DECODE_CTX + 8
    tokens = torch.ones((DECODE_ROWS, 1), dtype=torch.long, device=dev)
    start = torch.full((DECODE_ROWS,), DECODE_CTX, dtype=torch.int32,
                       device=dev)
    for shape in ((1, R), (2, R // 2), None):
        mesh = mesh_of(shape, dev) if shape else None
        p = shard_params(params, mesh) if mesh else params
        pool = llama.new_kv_cache(cfg, DECODE_ROWS, S, device=dev, mesh=mesh)
        pool.normal_(0, 1, generator=torch.Generator(device=dev)
                     .manual_seed(4))

        def step():
            llama.forward(p, cfg, tokens, start, pool, mesh=mesh)

        name = (f"decode step {shape[0]}x{shape[1]}" if shape
                else "decode step, no mesh")
        out[name] = {"ms": _time(step, dev), "rows": DECODE_ROWS,
                     "context": DECODE_CTX}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, dev, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


class Record(dict):
    """A rank's results, written to its file at every case, so that a rank
    that hangs leaves what it finished."""

    def __init__(self, path):
        super().__init__()
        self.path = path

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        with open(self.path, "w") as f:
            json.dump(self, f)


def rank_main(args):
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", args.rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{args.store}",
                            world_size=args.ranks, rank=args.rank)
    out = Record(os.path.join(args.out, f"rank{args.rank}.json"))
    try:
        with torch.no_grad():
            cfg, params = run_engines(args, dev, out)
            run_rings(cfg, params, dev, args.small, out)
            time_decode(cfg, params, dev, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0 if all(r.get("ok", True) for r in out.values()) else 1


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # "cuda" raises without a card
    if args.rank is not None:
        return rank_main(args)
    if args.ranks < 2 or args.ranks % 2:
        raise SystemExit("--ranks must be even and at least 2")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"{args.ranks} ranks need {args.ranks} cards; "
                             f"{torch.cuda.device_count()} visible")
        from lmcache_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    out_dir = args.out or tempfile.mkdtemp(prefix="mesh-check-")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(tempfile.mkdtemp(prefix="mesh-store-"), "store")
    base = [sys.executable, "-m", "lmcache_tpu_torch.tools.mesh_check",
            "--ranks", str(args.ranks), "--device", args.device,
            "--out", out_dir, "--store", store] + (
                ["--small"] if args.small else [])
    procs = [subprocess.Popen(base + ["--rank", str(r)])
             for r in range(args.ranks)]
    # a rank that fails leaves the others waiting in a collective: stop
    # them all at the first failure, or at the time limit
    deadline = time.perf_counter() + JOIN_SECONDS
    try:
        while time.perf_counter() < deadline:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rcs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ranks = []
    for r in range(args.ranks):
        path = os.path.join(out_dir, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    summary = {"card": card_line(), "ranks": args.ranks,
               "device": args.device, "rcs": rcs, "rank0": ranks[0],
               "decode_ms_by_rank": [
                   {k: v["ms"] for k, v in r.items() if k.startswith(
                       "decode")} if r else None for r in ranks]}
    print(json.dumps(summary))
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
