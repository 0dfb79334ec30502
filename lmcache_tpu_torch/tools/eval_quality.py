"""Codec quality gate: perplexity delta, logit KL and top-1 agreement after
a CacheGen round trip of the cached context's KV.

Port of ``tools/eval_quality.py``. The context's KV comes from a forward
over ``tokens[:ctx]``; it goes through the port's CacheGen serializer and
deserializer (on the card kernel rows 12 and 11); the continuation
``tokens[ctx:]`` is then scored once over the exact KV and once over the
decoded KV, and the two log-softmaxes (fp32) are compared:

- ``--model trained`` (the binding gate): the in-repo trained checkpoint
  (:mod:`lmcache_tpu_torch.tools.quality_common`), whose predictions depend
  on KV about ctx/2 tokens back; the perplexity delta must stay under
  ``PPL_DELTA_GATE``;
- ``--model trained-mla``: the same for the MLA checkpoint and its latent
  blobs (single-stream containers, the all-32 bins schedule);
- ``--model tiny|tinyllama|mla``: random weights, drawn from the port's
  ``init_params`` with a seeded ``torch.Generator``. Their logits are
  nearly flat, so KL and the confident top-1 agreement bind, not the
  perplexity. PyTorch's generator is not JAX's, so their numbers differ
  from the JAX tool's; only the trained models are held to it.

``--sweep`` runs the dense gate with uniform bins from the default schedule
down to 2: the KL and the perplexity delta must grow as the bins shrink.

    python -m lmcache_tpu_torch.tools.eval_quality --model trained
    python -m lmcache_tpu_torch.tools.eval_quality --model trained --sweep
    python -m lmcache_tpu_torch.tools.eval_quality --model trained-mla --json

It runs on the card in bf16 unless ``--device cpu`` (and ``--dtype
float32``, as the JAX tool computes) is given; on the CPU the range coders
run their plain versions, Python loops over the symbols (seconds a gate at
ctx 2048; ``coder="off"`` of :func:`evaluate` codes with the host C++ coder
instead).
"""

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from lmcache_tpu_torch.codec import CacheGenConfig
from lmcache_tpu_torch.config import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.storage.serde.cachegen_serde import (
    CacheGenDeserializer, CacheGenSerializer)
from lmcache_tpu_torch.tools import quality_common as qc
from lmcache_tpu_torch.utils import resolve_device

# the gates (the JAX tool's): the distribution shift must be small and
# greedy decoding stable. On random weights raw top-1 agreement measures
# tie-breaking on flat logits and is advisory; KL and the agreement at
# positions whose exact top-2 margin exceeds CONFIDENT_MARGIN nats bind. On
# the trained weights the perplexity delta binds too
KL_GATE = 0.05
CONFIDENT_TOP1_GATE = 0.99
PPL_DELTA_GATE = 0.1
CONFIDENT_MARGIN = 0.3  # nats


def _build_model(model: str, ctx: int, cont: int, seed: int, device,
                 dtype: str):
    """(cfg, params, tokens[ctx + cont], model_name)."""
    total = ctx + cont
    if model == "trained":
        cfg = qc.quality_config(dtype)
        params = qc.load_params(cfg, device=device)
        tokens = qc.make_eval_tokens(np.random.default_rng(seed), total)
        return cfg, params, tokens, "lmcache-tpu/quality-8l"
    cfg = (llama.LlamaConfig.tiny() if model == "tiny" else
           llama.LlamaConfig.tinyllama_1_1b())
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = llama.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, total,
                                                  dtype=np.int32)
    return cfg, params, tokens, "lmsys/longchat-7b-16k"


def context_blob(family, cfg, params, tokens: np.ndarray, ctx: int,
                 device) -> torch.Tensor:
    """The exact KV wire blob of ``tokens[:ctx]`` (``family`` is the model
    module, ``llama`` or ``mla``)."""
    new_cache = (llama.new_kv_cache if family is llama else
                 mla.new_latent_cache)
    cache = new_cache(cfg, 1, len(tokens), device=device)
    tok = torch.as_tensor(tokens[:ctx], device=device).long()[None]
    _, cache = family.forward(params, cfg, tok,
                              torch.zeros(1, dtype=torch.int32,
                                          device=device), cache)
    return family.cache_to_blob(cache, 0, ctx)


def codec_round_trip(blob: torch.Tensor, model_name: str, device,
                     cachegen_config=None, coder: str = "auto"):
    """(container bytes, decoded blob) of ``blob`` through the port's
    CacheGen serde, decoded on ``device``. ``cachegen_config`` overrides
    the bins schedule that the model name gives; ``coder`` is the config's
    ``cachegen_device_encode`` and ``_decode``: ``"auto"`` runs kernel rows
    12 and 11 on the card (their plain versions on the CPU), ``"off"`` the
    host C++ coder (the same containers)."""
    ecfg = LMCacheEngineConfig(remote_serde="cachegen",
                               remote_device=device.type,
                               cachegen_device_encode=coder,
                               cachegen_device_decode=coder)
    meta = LMCacheEngineMetadata(model_name=model_name, world_size=1,
                                 worker_id=0, fmt="vllm")
    bs = CacheGenSerializer(ecfg, meta,
                            cachegen_config=cachegen_config).to_bytes(blob)
    return bs, CacheGenDeserializer(ecfg, meta).from_bytes(bs)


def _continuation_logp(family, cfg, params, tokens, ctx, blob, device):
    """Log-probs (fp32) of the continuation given the context's KV blob:
    [cont - 1, V] (token t is predicted at position t - 1)."""
    new_cache = (llama.new_kv_cache if family is llama else
                 mla.new_latent_cache)
    cache = family.blob_into_cache(
        new_cache(cfg, 1, len(tokens), device=device), blob)
    tok = torch.as_tensor(tokens[ctx:], device=device).long()[None]
    logits, _ = family.forward(
        params, cfg, tok, torch.full((1, ), ctx, dtype=torch.int32,
                                     device=device), cache)
    return torch.log_softmax(logits[0, :-1].float(), dim=-1)


def _ppl(nll: float) -> float:
    """exp(nll), the exponent capped at 700 (a destroyed cache can push the
    nll past the float range, or to nan)."""
    if not np.isfinite(nll):
        nll = 700.0
    return float(np.exp(min(nll, 700.0)))


def _compare(lp_exact, lp_codec, tokens, ctx):
    """The gate's numbers of two continuation log-prob tables."""
    kl = float((lp_exact.exp() * (lp_exact - lp_codec)).sum(-1).mean())
    agree = lp_exact.argmax(-1) == lp_codec.argmax(-1)
    top2 = lp_exact.topk(2, dim=-1).values
    margins = top2[:, 0] - top2[:, 1]
    # the margin is capped at the 90th percentile of the margins, so that
    # at least the most confident decile counts: on flat logits no position
    # might reach CONFIDENT_MARGIN and the gate would pass on KL alone
    margin_eff = float(min(CONFIDENT_MARGIN,
                           float(torch.quantile(margins, 0.9))))
    confident = margins >= margin_eff
    n_conf = int(confident.sum())
    tgt = torch.as_tensor(tokens[ctx + 1:], device=lp_exact.device).long()

    def nll(lp):
        return float(-lp.gather(1, tgt[:, None]).mean())

    return {
        "kl": kl,
        "top1": float(agree.float().mean()),
        "conf_top1": float(agree[confident].sum()) / max(n_conf, 1),
        "n_conf": n_conf,
        "margin_eff": margin_eff,
        "ppl_exact": _ppl(nll(lp_exact)),
        "ppl_codec": _ppl(nll(lp_codec)),
    }


def _passes(m: dict, binding: bool) -> bool:
    ok = m["kl"] <= KL_GATE and m["conf_top1"] >= CONFIDENT_TOP1_GATE
    return ok and (not binding
                   or m["ppl_codec"] - m["ppl_exact"] < PPL_DELTA_GATE)


def evaluate(model: str = "tiny", ctx: int = 256, cont: int = 64,
             seed: int = 0, cachegen_config=None, device="cuda",
             dtype: str = "bfloat16", coder: str = "auto") -> dict:
    """The codec quality of a llama-family model (the JAX tool's
    ``evaluate``; its result dict and keys). ``coder`` as in
    :func:`codec_round_trip`."""
    dev = resolve_device(device)
    cfg, params, tokens, model_name = _build_model(model, ctx, cont, seed,
                                                   dev, dtype)
    exact = context_blob(llama, cfg, params, tokens, ctx, dev)
    bs, decoded = codec_round_trip(exact, model_name, dev, cachegen_config,
                                   coder)
    m = _compare(
        _continuation_logp(llama, cfg, params, tokens, ctx, exact, dev),
        _continuation_logp(llama, cfg, params, tokens, ctx, decoded, dev),
        tokens, ctx)
    ratio = exact.numel() * exact.element_size() / len(bs)
    return {
        "model": model,
        "ctx": ctx,
        "cont": cont,
        "compression_x": round(float(ratio), 3),
        "logit_kl": round(m["kl"], 5),
        "top1_agreement": round(m["top1"], 4),
        "confident_top1_agreement": round(m["conf_top1"], 4),
        "confident_positions": m["n_conf"],
        "confident_margin_nats": round(m["margin_eff"], 4),
        "ppl_exact": round(m["ppl_exact"], 4),
        "ppl_codec": round(m["ppl_codec"], 4),
        "ppl_delta": round(m["ppl_codec"] - m["ppl_exact"], 4),
        "ppl_gate_binding": model == "trained",
        "pass": _passes(m, model == "trained"),
    }


def evaluate_mla(ctx: int = 256, cont: int = 64, seed: int = 0,
                 cachegen_config=None, trained: bool = False,
                 device="cuda", dtype: str = "bfloat16",
                 coder: str = "auto") -> dict:
    """The codec quality of MLA latent blobs (the JAX tool's
    ``evaluate_mla``): single-stream containers under the latent bins
    schedule; with ``trained`` the MLA checkpoint, whose perplexity delta
    binds. The compression is against the latents in bf16."""
    dev = resolve_device(device)
    total = ctx + cont
    if trained:
        cfg, params, tokens = qc.load_mla_checkpoint(ctx, cont, seed,
                                                     dtype=dtype, device=dev)
        model_name = "trained-mla"
    else:
        cfg = mla.MLAConfig(
            vocab_size=8000, dim=512, n_layers=4, n_heads=8,
            hidden_dim=1024, max_seq_len=max(1024, total),
            q_lora_rank=None, kv_lora_rank=256, qk_nope_head_dim=64,
            qk_rope_head_dim=32, v_head_dim=64, dtype=dtype)
        params = mla.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed + 3),
            device=dev)
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, total, dtype=np.int32)
        model_name = "mla-random"
    exact = context_blob(mla, cfg, params, tokens, ctx, dev)
    bs, decoded = codec_round_trip(exact, model_name, dev, cachegen_config,
                                   coder)
    m = _compare(
        _continuation_logp(mla, cfg, params, tokens, ctx, exact, dev),
        _continuation_logp(mla, cfg, params, tokens, ctx, decoded, dev),
        tokens, ctx)
    return {
        "model": model_name,
        "ctx": ctx,
        "cont": cont,
        "latent_dim": cfg.latent_dim,
        "compression_vs_bf16_x": round(exact.numel() * 2 / len(bs), 3),
        "logit_kl": round(m["kl"], 5),
        "top1_agreement": round(m["top1"], 4),
        "confident_top1_agreement": round(m["conf_top1"], 4),
        "ppl_exact": round(m["ppl_exact"], 4),
        "ppl_codec": round(m["ppl_codec"], 4),
        "ppl_delta": round(m["ppl_codec"] - m["ppl_exact"], 4),
        "ppl_gate_binding": bool(trained),
        "pass": _passes(m, trained),
    }


def sweep(model: str, ctx: int, cont: int, seed: int, device="cuda",
          dtype: str = "bfloat16", coder: str = "auto") -> list:
    """The bins -> quality curve: the default schedule, then uniform key
    and value bins of 16, 8, 4 and 2. The delta must grow as the bins
    shrink, which shows that the gate measures codec damage."""
    L = (qc.quality_config().n_layers if model == "trained" else
         llama.LlamaConfig.tiny().n_layers if model == "tiny" else
         llama.LlamaConfig.tinyllama_1_1b().n_layers)
    rows = []
    for bins in (None, 16, 8, 4, 2):
        cg = (None if bins is None else
              CacheGenConfig(key_bins=(bins, ) * L, value_bins=(bins, ) * L))
        r = evaluate(model, ctx, cont, seed, cachegen_config=cg,
                     device=device, dtype=dtype, coder=coder)
        r["bins"] = bins or "default"
        rows.append(r)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    choices=["tiny", "tinyllama", "trained", "mla",
                             "trained-mla"])
    ap.add_argument("--ctx", type=int, default=None)
    ap.add_argument("--cont", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="bins -> quality curve instead of one gate run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if args.ctx is None:
        # the trained models retrieve from ~ctx/2 back: a real distance
        args.ctx = (2048 if args.model in ("trained", "trained-mla")
                    else 256)
    run = dict(device=args.device, dtype=args.dtype)

    if args.model in ("mla", "trained-mla"):
        result = evaluate_mla(args.ctx, args.cont, args.seed,
                              trained=args.model == "trained-mla", **run)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"model={result['model']} ctx={result['ctx']} "
                  f"compression(bf16)={result['compression_vs_bf16_x']}x "
                  f"kl={result['logit_kl']} "
                  f"conf_top1={result['confident_top1_agreement']} "
                  f"ppl_delta={result['ppl_delta']} "
                  f"pass={result['pass']}")
        return 0 if result["pass"] else 1

    if args.sweep:
        rows = sweep(args.model, args.ctx, args.cont, args.seed, **run)
        if args.json:
            print(json.dumps(rows))
        else:
            print(f"model={args.model} ctx={args.ctx} (gate: ppl delta "
                  f"< {PPL_DELTA_GATE} at default bins)")
            print(f"{'bins':>8} {'compression':>12} {'ppl_exact':>10} "
                  f"{'ppl_codec':>10} {'ppl_delta':>10} {'logit_kl':>9}")
            for r in rows:
                print(f"{str(r['bins']):>8} {r['compression_x']:>11.2f}x "
                      f"{r['ppl_exact']:>10.4g} {r['ppl_codec']:>10.4g} "
                      f"{r['ppl_delta']:>+10.4g} {r['logit_kl']:>9.4g}")
        return 0

    result = evaluate(args.model, args.ctx, args.cont, args.seed, **run)
    if args.json:
        print(json.dumps(result))
    else:
        print(f"model={result['model']} ctx={result['ctx']} "
              f"cont={result['cont']}")
        print(f"compression   : {result['compression_x']:.2f}x")
        print(f"logit KL      : {result['logit_kl']:.5f}  "
              f"(gate <= {KL_GATE})")
        print(f"top-1 agree   : {result['top1_agreement']*100:.2f}%  "
              f"(advisory — tie noise on flat logits)")
        print(f"confident t1  : "
              f"{result['confident_top1_agreement']*100:.2f}% over "
              f"{result['confident_positions']} pos "
              f"(gate >= {CONFIDENT_TOP1_GATE*100}%)")
        print(f"ppl exact     : {result['ppl_exact']:.4f}")
        print(f"ppl codec     : {result['ppl_codec']:.4f}")
        print(f"ppl delta     : {result['ppl_delta']:+.4f}"
              + (f"  (gate < {PPL_DELTA_GATE}, BINDING)"
                 if result["ppl_gate_binding"] else "  (advisory)"))
        print("PASS" if result["pass"] else "FAIL")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
