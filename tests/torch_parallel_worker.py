"""One rank of the port's multi-rank CPU checks (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py RANK WORLD STORE INPUTS OUT

joins a gloo process group of WORLD ranks through the file STORE, runs every
case of ``ENGINES``, ``BLENDS``, ``RINGS`` and ``FORWARD_RINGS`` on the mesh
it names with the inputs and weights in the ``.npz`` INPUTS (written by the
test), and saves what this rank computed to ``OUT/rank<RANK>.pt``. It imports the port
only, never JAX; one torch thread a rank.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lmcache_tpu_torch import (LMCacheEngine, LMCacheEngineConfig,  # noqa: E402
                               LMCacheEngineMetadata)
from lmcache_tpu_torch.chunks import prefix_chunk_hashes  # noqa: E402
from lmcache_tpu_torch.models import llama, mla  # noqa: E402
from lmcache_tpu_torch.parallel import (MeshConfig, make_mesh,  # noqa: E402
                                        ring_attention, shard_params)
from lmcache_tpu_torch.parallel.mesh import shard_metadata  # noqa: E402
from lmcache_tpu_torch.serving import (MLAPagedServingEngine,  # noqa: E402
                                       MLAServingEngine, PagedServingEngine,
                                       Request, SamplingParams, ServingEngine)

WORLD = 4
NEW_TOKENS = 6
PROMPTS = (21, 17)  # prompt lengths, drawn by the test
DENSE = dict(n_layers=2, n_heads=8, n_kv_heads=4, dim=512, hidden_dim=512)
# model configs (the kwargs of LlamaConfig.tiny, or of MLAConfig.tiny)
MODELS = {
    "dense": DENSE,
    "moe": dict(DENSE, n_experts=4, n_experts_per_tok=2,
                moe_hidden_dim=256),
    "gemma3": dict(DENSE, n_layers=4, sliding_window=16,
                   global_layer_map=(False, False, False, True),
                   rope_theta=1e6, rope_local_theta=1e4, qk_norm=True,
                   norm_one_offset=True, post_norms=True,
                   mlp_act="gelu_tanh", embed_scale=True),
    "gpt_oss": dict(DENSE, n_layers=4, attention_bias=True, attn_sinks=True,
                    sliding_window=16, sliding_window_pattern=2,
                    n_experts=4, n_experts_per_tok=2, moe_hidden_dim=256,
                    moe_style="gpt_oss"),
    "olmo2": dict(DENSE, qk_norm_flat=True, pre_norms=False,
                  post_norms=True),
    "gathered": dict(DENSE, n_kv_heads=2),
    "mla": dict(n_layers=2, n_routed_experts=4, n_shared_experts=1,
                n_experts_per_tok=2, moe_hidden_dim=64,
                first_k_dense_replace=1, q_lora_rank=32),
    "ring": dict(n_layers=2, n_heads=4, n_kv_heads=2, qk_norm=True),
    "ring_gemma3": dict(n_layers=2, n_heads=4, n_kv_heads=2,
                        sliding_window=24, global_layer_map=(False, True),
                        rope_theta=1e6, rope_local_theta=1e4, qk_norm=True,
                        norm_one_offset=True, post_norms=True,
                        mlp_act="gelu_tanh", embed_scale=True),
}
# engine cases: (model, engine, mesh (data, model), prompts, options)
ENGINES = {
    "dense 1x4": ("dense", "dense", (1, 4), 2, {}),
    "dense 2x2": ("dense", "dense", (2, 2), 2, {}),
    "paged 1x4": ("dense", "paged", (1, 4), 2, {}),
    "paged 2x2": ("dense", "paged", (2, 2), 2, {}),
    "moe 1x4": ("moe", "dense", (1, 4), 1, {}),
    "gemma3 1x4": ("gemma3", "dense", (1, 4), 1, {}),
    "gpt_oss 1x4": ("gpt_oss", "dense", (1, 4), 1, {}),
    "olmo2 1x4": ("olmo2", "paged", (1, 4), 1, {}),
    "gathered 1x4": ("gathered", "dense", (1, 4), 1, {}),
    "mla 1x4": ("mla", "mla", (1, 4), 1, {}),
    "mla 2x2": ("mla", "mla", (2, 2), 2, {}),
    "mla paged 1x4": ("mla", "mla_paged", (1, 4), 1, {}),
    "dense int8 1x4": ("dense", "dense", (1, 4), 2, {"kv_dtype": "int8"}),
    "dense int8 2x2": ("dense", "dense", (2, 2), 2, {"kv_dtype": "int8"}),
    "paged int8 1x4": ("dense", "paged", (1, 4), 2, {"kv_dtype": "int8"}),
}
# the cases whose ranks store into a shared per-shard disk tier; a second
# engine on fresh cache engines over that directory then generates the
# same prompts again, retrieving them
TIERED = ("dense 1x4", "dense 2x2", "paged 1x4", "dense int8 1x4",
          "dense int8 2x2", "paged int8 1x4")
# CacheBlend requests: (model, engine, mesh, options); the three context
# chunks of BLEND_DOCS tokens drawn by the test
BLENDS = {
    "blend 1x4": ("dense", "dense", (1, 4), {}),
    "blend 2x2": ("dense", "dense", (2, 2), {}),
    "blend paged int8 1x4": ("dense", "paged", (1, 4), {"kv_dtype": "int8"}),
    "mla blend 1x4": ("mla", "mla", (1, 4), {}),
}
BLEND_DOCS = 24
BLEND_RATIO = 0.15
# ring attention: (mesh, options); q/k/v of RING_SHAPE drawn by the test
RING_SHAPE = (2, 64, 2, 2, 16)  # B, T, H_kv, G, D
RINGS = {
    "plain 4x1": ((4, 1), {}),
    "plain 2x2": ((2, 2), {}),
    "softcap 4x1": ((4, 1), dict(sm_scale=0.2, logit_softcap=30.0)),
    "sliding 4x1": ((4, 1), dict(sliding_window=24)),
    "chunked 2x2": ((2, 2), dict(sliding_window=20,
                                 window_kind="chunked")),
    "global 4x1": ((4, 1), dict(sliding_window=20, window_kind="chunked",
                                is_global=True)),
    "sinks 2x2": ((2, 2), dict(sinks=True)),
    "ragged chunked 4x1": ((4, 1), dict(sliding_window=20,
                                        window_kind="chunked",
                                        ragged=True)),
}
# forward_ring: (model, mesh); tokens [2, RING_T] drawn by the test
RING_T = 64
FORWARD_RINGS = {
    "ring 4x1": ("ring", (4, 1)),
    "ring 2x2": ("ring", (2, 2)),
    "ring_gemma3 4x1": ("ring_gemma3", (4, 1)),
}
CHUNK = 16  # the cache tier's chunk size (the pages' size too)


_MESHES = {}


def mesh_of(shape):
    """One ``DeviceMesh`` a shape for the whole run (each makes its
    groups)."""
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(MeshConfig(*shape), "cpu")
    return _MESHES[shape]


def config(model):
    kw = MODELS[model]
    if model == "mla":
        return mla.MLAConfig.tiny(**kw)
    return llama.LlamaConfig.tiny(**kw)


def tree(inputs, prefix):
    """The nested parameter dict stored under ``prefix/`` in the npz."""
    out = {}
    for key in inputs.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inputs[key]
    return out


def params(inputs, model):
    cfg = config(model)
    module = mla if model == "mla" else llama
    return cfg, module.params_from_jax(tree(inputs, model), cfg,
                                       device="cpu")


def agree(name, tokens):
    """The debug check of a mesh engine: every rank sampled the same
    tokens."""
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, tokens)
    if any(t != tokens for t in everyone):
        raise AssertionError(f"{name}: the ranks disagree: {everyone}")


def engine(kind, cfg, prm, mesh, cache, opts):
    common = dict(max_batch=2, max_seq=128, device="cpu", mesh=mesh,
                  cache_engine=cache, **opts)
    if kind == "dense":
        return ServingEngine(cfg, prm, **common)
    if kind == "paged":
        return PagedServingEngine(cfg, prm, num_pages=24, page_size=CHUNK,
                                  **common)
    if kind == "mla":
        return MLAServingEngine(cfg, prm, **common)
    return MLAPagedServingEngine(cfg, prm, num_pages=24, page_size=CHUNK,
                                 **common)


def tier(path, model, meta_mesh=None, world_size=1, worker_id=0):
    meta = LMCacheEngineMetadata(model_name=model, world_size=world_size,
                                 worker_id=worker_id, fmt="vllm",
                                 dtype="float32")
    if meta_mesh is not None:
        meta = shard_metadata(meta, meta_mesh)
    return LMCacheEngine(LMCacheEngineConfig.from_defaults(
        local_device=path, chunk_size=CHUNK), meta)


def run_engines(inputs, tmp, out):
    prompts = [inputs[f"prompt{i}"] for i in range(len(PROMPTS))]
    sampling = SamplingParams(max_new_tokens=NEW_TOKENS)
    for name, (model, kind, shape, n, opts) in ENGINES.items():
        mesh = mesh_of(shape)
        cfg, whole = params(inputs, model)
        sharded = shard_params(whole, mesh)
        path = os.path.join(tmp, "tier " + name)
        cache = tier(path, "mesh", mesh) if name in TIERED else None
        eng = engine(kind, cfg, sharded, mesh, cache, opts)
        reqs = eng.generate(prompts[:n], sampling)
        toks = [r.output_tokens for r in reqs]
        agree(name, toks)
        res = {"tokens": toks}
        if opts:
            # the same engine without a mesh, on every rank
            plain = engine(kind, cfg, whole, None, None, opts)
            res["plain"] = [r.output_tokens
                            for r in plain.generate(prompts[:n], sampling)]
        if cache is not None:
            cache.engine_.flush()
            dist.barrier()
            cache.close()
            # a new engine whose cache engine replays the directory
            again = tier(path, "mesh", mesh)
            eng = engine(kind, cfg, sharded, mesh, again, opts)
            second = eng.generate(prompts[:n], sampling)
            res["second"] = [r.output_tokens for r in second]
            res["second_cached"] = [r.cached_prefix_len for r in second]
            if opts.get("kv_dtype") == "int8":
                res["second_scale"] = injected_scales(eng, prompts[0])
            agree(name + " again", res["second"])
            again.close()
            dist.barrier()
        if name == "dense 1x4":
            res.update(shard_tier(path, prompts[0], reqs[0]))
        out[name] = res


def run_blends(inputs, tmp, out):
    """One ``context_chunks`` request a case, on a per-shard disk tier."""
    docs = [inputs[f"blend_doc{i}"] for i in range(3)]
    for name, (model, kind, shape, opts) in BLENDS.items():
        mesh = mesh_of(shape)
        cfg, whole = params(inputs, model)
        cache = tier(os.path.join(tmp, name), "blend", mesh)
        eng = engine(kind, cfg, shard_params(whole, mesh), mesh, cache,
                     dict(opts, blend_recompute_ratio=BLEND_RATIO))
        req = Request(np.empty(0, np.int32),
                      SamplingParams(max_new_tokens=NEW_TOKENS),
                      context_chunks=docs)
        eng.add_request(req)
        eng.run()
        agree(name, req.output_tokens)
        # the blender once more over the now cached chunks: its last
        # logits and this rank's healed blob
        logits, blob, _ = eng._get_blender().blend(docs)
        out[name] = {"tokens": req.output_tokens,
                     "cached": req.cached_prefix_len,
                     "recomputed": req.blended_tokens_recomputed,
                     "logits": logits.numpy(), "blob": blob.numpy()}
        cache.close()


def injected_scales(eng, prompt):
    """The int8 pool's scales [L, 2, CHUNK] of the first CHUNK tokens of
    ``prompt``, which the second pass injected from the tier: slot 0's (the
    first request's) in a dense pool, the resident first page's in an
    arena; None on a rank that does not hold slot 0."""
    scale = eng.kv_pool["scale"]
    if kind_of(eng) == "paged":
        page = eng._resident[prefix_chunk_hashes(prompt, CHUNK)[0]]
        return scale[:, :, page].numpy()
    if not eng._owns(0):
        return None
    return scale[:, :, eng._local(0), :CHUNK].numpy()


def kind_of(eng):
    return "paged" if isinstance(eng, PagedServingEngine) else "dense"


def shard_tier(path, prompt, req):
    """Per-shard store and retrieve: a fresh tier over the shared
    directory retrieves each worker's head slice under that worker's key
    namespace, which a deployment of another world size does not see."""
    n = len(prompt)
    res = {"blob": [], "hits": []}
    for w in range(4):
        t = tier(path, "mesh", world_size=4, worker_id=w)
        blob, mask = t.retrieve(prompt, return_tuple=False)
        res["blob"].append(blob.numpy())
        res["hits"].append(int(mask.sum()))
        t.close()
    other = tier(path, "mesh", world_size=2, worker_id=0)
    res["other_world_hits"] = other.lookup(prompt)
    other.close()
    res["stored_tokens"] = n
    res["cached_prefix_len"] = req.cached_prefix_len
    return res


def run_rings(inputs, out):
    B, T, Hkv, G, D = RING_SHAPE
    q, k, v = (torch.from_numpy(inputs[f"ring_{x}"]) for x in "qkv")
    for name, (shape, opts) in RINGS.items():
        mesh = mesh_of(shape)
        kw = dict(opts)
        offs = np.zeros(B, np.int32)
        kvl = np.asarray([T, T - 14], np.int32)
        if kw.pop("ragged", False):
            offs = np.asarray([0, 19], np.int32)
            kvl = offs + np.asarray([T, T - 8], np.int32)
        if kw.pop("sinks", False):
            kw["sinks"] = torch.from_numpy(inputs["ring_sinks"])
        o = ring_attention(q, k, v, torch.from_numpy(offs),
                           torch.from_numpy(kvl), mesh, **kw)
        out[name] = {"out": o.numpy(), "offsets": offs, "kv_len": kvl}


def run_forward_rings(inputs, out):
    for name, (model, shape) in FORWARD_RINGS.items():
        mesh = mesh_of(shape)
        cfg, whole = params(inputs, model)
        tokens = torch.from_numpy(inputs["ring_tokens"]).long()
        logits, cache = llama.forward_ring(shard_params(whole, mesh), cfg,
                                           tokens, mesh)
        last, _ = llama.forward_ring(shard_params(whole, mesh), cfg, tokens,
                                     mesh, last_logit_only=True)
        out[name] = {"logits": logits.numpy(), "cache": cache.numpy(),
                     "last": last.numpy()}


def main(rank, world, store, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    inputs = np.load(inputs_path)
    out = {}
    with torch.no_grad():
        run_engines(inputs, out_dir, out)
        run_blends(inputs, out_dir, out)
        run_rings(inputs, out)
        run_forward_rings(inputs, out)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
