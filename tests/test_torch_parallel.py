"""The port's parallelism (``lmcache_tpu_torch.parallel``, ``mesh=`` of the
forwards, the four engines and the blenders) on the CPU against the JAX
package's mesh.

The single-process cases hold ``shard_params`` to the addressable shards of
the JAX ``shard_params`` on a (1, 4) mesh of the 8 virtual CPU devices,
``shard_blob_slice``, the allocators' local shapes and the metadata's
``kv_shard_axis``. The multi-rank cases come from ONE launch of four gloo
ranks for the module (``tests/torch_parallel_worker.py``, no JAX there):
the engines at (1, 4) and (2, 2), native and int8, and where tiered a
second engine over the per-shard tier that the first filled; CacheBlend
requests; ring attention at (4, 1) and (2, 2); ``forward_ring``; the
per-shard cache tier. Their arrays come back here and each case holds them
to JAX on the CPU. Tolerances: tokens and cached prefix lengths equal;
ring attention 2e-5 and ``forward_ring``'s logits 2e-4, its cache 2e-5 (the
JAX package's own ring tests' rules, against the JAX forward and, at
(2, 2), the JAX ``forward_ring``); the stored KV, the injected int8 scales
and the blenders' logits and healed blobs 2e-5 (fp32, the port's blend
files' rule).
"""

import concurrent.futures
import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as W
from torch_test_helpers import FakeMesh
from lmcache_tpu import LMCacheEngine as JCacheEngine
from lmcache_tpu import LMCacheEngineConfig as JConfig
from lmcache_tpu import LMCacheEngineMetadata as JMetadata
from lmcache_tpu.chunks import prefix_chunk_hashes as jprefix_chunk_hashes
from lmcache_tpu.models import llama as jllama
from lmcache_tpu.models import mla as jmla
from lmcache_tpu.ops.attention import mha_reference as jmha
from lmcache_tpu.parallel import MeshConfig as JMeshConfig
from lmcache_tpu.parallel import make_mesh as jmake_mesh
from lmcache_tpu.parallel import shard_blob_slice as jshard_blob_slice
from lmcache_tpu.parallel import shard_params as jshard_params
from lmcache_tpu.parallel.ring_attention import ring_attention as jring
from lmcache_tpu.serving import MLAServingEngine as JMLAServingEngine
from lmcache_tpu.serving import PagedServingEngine as JPagedServingEngine
from lmcache_tpu.serving import Request as JRequest
from lmcache_tpu.serving import SamplingParams as JSamplingParams
from lmcache_tpu.serving import ServingEngine as JServingEngine
from lmcache_tpu_torch import LMCacheEngineMetadata
from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.parallel import shard_blob_slice, shard_params
from lmcache_tpu_torch.parallel.mesh import shard_metadata

ATOL_RING = 2e-5
ATOL_RING_LOGITS = 2e-4
ATOL_KV = 2e-5
JOIN_SECONDS = 120
# XLA's backend optimizations off: a shorter compile of each JAX reference
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
SEEDS = {"dense": 7, "moe": 11, "gemma3": 21, "gpt_oss": 31, "olmo2": 41,
         "gathered": 51, "mla": 13, "ring": 0, "ring_gemma3": 2}


def _jax_config(model):
    if model == "mla":
        return jmla.MLAConfig.tiny(**W.MODELS[model])
    return jllama.LlamaConfig.tiny(**W.MODELS[model])


@functools.lru_cache(maxsize=None)
def jax_params(model):
    """Weights of the model in the JAX tree's layout, as numpy: the port's
    ``init_params`` (the JAX tree's keys and shapes) from a seeded
    generator, with every norm, bias and sink moved off its identity, so
    that each slice carries weight."""
    cfg = W.config(model)
    module = mla if model == "mla" else llama
    tree = jax.tree.map(lambda t: t.numpy(), module.init_params(
        cfg, torch.Generator().manual_seed(SEEDS[model]), device="cpu"))
    rng = np.random.default_rng(SEEDS[model])
    for block in ("layers", "dense_layers", "moe_layers"):
        for name, x in tree.get(block, {}).items():
            if name.endswith("norm") or name in (
                    "bq", "bk", "bv", "e_bg", "e_bu", "e_bd", "sinks",
                    "router_b"):
                tree[block][name] = (x + 0.2 * rng.standard_normal(x.shape)
                                     ).astype(np.float32)
    return tree


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _inputs():
    rng = np.random.default_rng(0)
    arrays = {f"prompt{i}": rng.integers(0, 512, n, dtype=np.int32)
              for i, n in enumerate(W.PROMPTS)}
    B, T, Hkv, G, D = W.RING_SHAPE
    for x, shape in (("q", (B, T, Hkv * G, D)), ("k", (B, T, Hkv, D)),
                     ("v", (B, T, Hkv, D))):
        arrays[f"ring_{x}"] = rng.standard_normal(shape).astype(np.float32)
    arrays["ring_sinks"] = rng.standard_normal(Hkv * G).astype(np.float32)
    arrays["ring_tokens"] = rng.integers(0, 512, (2, W.RING_T),
                                         dtype=np.int32)
    for i in range(3):
        arrays[f"blend_doc{i}"] = rng.integers(0, 512, W.BLEND_DOCS,
                                               dtype=np.int32)
    for model in W.MODELS:
        arrays.update(_flat(jax_params(model), model))
    return arrays


def _launch(tmp):
    arrays = _inputs()
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, str(r), str(W.WORLD), store, path, tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(W.WORLD)]
    return arrays, procs


def _join(procs):
    deadline = time.monotonic() + JOIN_SECONDS
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not finish in {JOIN_SECONDS} s")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


# the port's engine cases held to the JAX mesh engines, and those held to
# the JAX model's greedy choices
JAX_ENGINE_CASES = ["dense 1x4", "dense 2x2", "paged 1x4", "paged 2x2",
                    "dense int8 1x4", "dense int8 2x2", "paged int8 1x4"]
TEACHER_CASES = ["moe 1x4", "gemma3 1x4", "gpt_oss 1x4", "olmo2 1x4",
                 "gathered 1x4", "mla 1x4", "mla 2x2", "mla paged 1x4"]


def _jax_key(case):
    """The JAX mesh engine a port engine case is held to: (engine, kv
    dtype, mesh shape); the native pools' cases at (2, 2) are held to the
    engine at (1, 4), whose tokens the mesh's shape does not change."""
    _, kind, shape, _, opts = W.ENGINES[case]
    kv_dtype = opts.get("kv_dtype", "native")
    return kind, kv_dtype, (1, 4) if kv_dtype == "native" else shape


def _jax_blend_key(case):
    """The JAX mesh engine at (1, 4) that runs the CacheBlend request a port
    case is held to: (engine, kv dtype, mesh shape), the MLA engine under
    "mla"."""
    _, kind, _, opts = W.BLENDS[case]
    return kind, opts.get("kv_dtype", "native"), (1, 4)


def _jax_mesh_engines(arrays):
    """The JAX mesh engines, one for each engine, kv dtype and mesh shape of
    ``JAX_ENGINE_CASES`` and of the CacheBlend cases: greedy tokens of both
    prompts, then, where the port's case is tiered, the same engine's
    second pass over the tier that its first pass filled (tokens, cached
    prefix lengths, int8 scales); the first prompt's KV as the native dense
    engine at (1, 4) stored it; and where a CacheBlend case is held to the
    engine, its ``context_chunks`` request (under "blend")."""
    prompts = [arrays[f"prompt{i}"] for i in range(len(W.PROMPTS))]
    docs = [arrays[f"blend_doc{i}"] for i in range(3)]
    sampling = JSamplingParams(max_new_tokens=W.NEW_TOKENS)
    served = {_jax_key(case) for case in JAX_ENGINE_CASES}
    tiered = {_jax_key(case) for case in W.TIERED}
    blended = {_jax_blend_key(case) for case in W.BLENDS}

    def run(key):
        kind, kv_dtype, shape = key
        model = "mla" if kind == "mla" else "dense"
        cfg = _jax_config(model)
        mesh = jmake_mesh(JMeshConfig(*shape))
        cache = JCacheEngine(
            JConfig.from_defaults(local_device="cpu", chunk_size=W.CHUNK),
            JMetadata(model_name="mesh", world_size=1, worker_id=0,
                      fmt="vllm", dtype="float32"))
        common = dict(max_batch=2, max_seq=128, use_pallas=False, mesh=mesh,
                      cache_engine=cache, kv_dtype=kv_dtype,
                      blend_recompute_ratio=W.BLEND_RATIO)
        prm = jshard_params(jax_params(model), mesh)
        make = {"dense": JServingEngine, "mla": JMLAServingEngine}.get(kind)
        eng = (make(cfg, prm, **common) if make is not None else
               JPagedServingEngine(cfg, prm, num_pages=24,
                                   page_size=W.CHUNK, **common))
        res = {}
        if key in served:
            res["tokens"] = [r.output_tokens
                             for r in eng.generate(prompts, sampling)]
            cache.engine_.flush()
        if key == ("dense", "native", (1, 4)):
            blob, _ = cache.retrieve(prompts[0], return_tuple=False)
            res["blob"] = np.asarray(blob)
        if key in tiered:
            second = eng.generate(prompts, sampling)
            res["second"] = [r.output_tokens for r in second]
            res["second_cached"] = [r.cached_prefix_len for r in second]
            if kv_dtype == "int8":
                scale = eng.kv_pool["scale"]
                if kind == "paged":
                    page = eng._resident[jprefix_chunk_hashes(
                        prompts[0], W.CHUNK)[0]]
                    res["second_scale"] = np.asarray(scale[:, :, page])
                else:
                    res["second_scale"] = np.asarray(
                        scale[:, :, 0, :W.CHUNK])
        if key in blended:
            req = JRequest(np.empty(0, np.int32), sampling,
                           context_chunks=docs)
            eng.add_request(req)
            eng.run()
            logits, blob, _ = eng._blender.blend(docs)
            res["blend"] = {"tokens": req.output_tokens,
                            "cached": req.cached_prefix_len,
                            "logits": np.asarray(logits),
                            "blob": np.asarray(blob)}
        cache.close()
        return res

    # one thread an engine: their compiles overlap
    keys = sorted(served | blended)
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        return dict(zip(keys, pool.map(run, keys)))


def _ring_references(arrays):
    q, k, v = (jnp.asarray(arrays[f"ring_{x}"]) for x in "qkv")
    B, T = q.shape[:2]
    refs = {}
    for name, (shape, opts) in W.RINGS.items():
        kw = dict(opts)
        o = jnp.zeros(B, jnp.int32)
        kvl = jnp.asarray([T, T - 14], jnp.int32)
        if kw.pop("ragged", False):
            o = jnp.asarray([0, 19], jnp.int32)
            kvl = o + jnp.asarray([T, T - 8], jnp.int32)
            refs[name] = _ring_offsets_reference(
                arrays, np.asarray(o), np.asarray(kvl), kw["sliding_window"])
            continue
        if kw.pop("sinks", False):
            kw["sinks"] = jnp.asarray(arrays["ring_sinks"])
        if name.startswith("plain"):
            # the JAX ring itself on the same mesh shape
            devs = np.asarray(jax.devices()[:4]).reshape(shape)
            mesh = jax.sharding.Mesh(devs, ("data", "model"))
            refs[name] = np.asarray(jax.jit(
                lambda *a, mesh=mesh: jring(*a, mesh),
                compiler_options=FAST_COMPILE)(q, k, v, o, kvl))
            continue
        g = kw.pop("is_global", False)
        if g:
            kw.pop("sliding_window"), kw.pop("window_kind")
        ref = np.asarray(jmha(q, k, v, o, kvl, **kw))
        # a query that sees no key: 0 from the ring, as from the JAX ring,
        # the uniform average of V from mha_reference
        refs[name] = np.where(_dead_rows(o, kvl, T, kw)[:, :, None, None],
                              0.0, ref)
    return refs


def _dead_rows(o, kvl, T, kw):
    """[B, T] rows that see no key under the options ``kw``."""
    pos = np.arange(T)
    qpos = np.asarray(o)[:, None] + pos[None]
    kpos = pos[None, None, :]
    live = (kpos <= qpos[:, :, None]) & (
        kpos < np.asarray(kvl)[:, None, None])
    W_ = kw.get("sliding_window")
    if W_ is not None:
        if kw.get("window_kind") == "chunked":
            live &= kpos // W_ == qpos[:, :, None] // W_
        else:
            live &= kpos > qpos[:, :, None] - W_
    if kw.get("sinks") is not None:
        return np.zeros(live.shape[:2], bool)
    return ~live.any(-1)


def _ring_offsets_reference(arrays, o, kvl, W_):
    """The ring's position convention with ragged offsets (row b's keys at
    ``o[b] + [0, T)``), chunked windows, dead rows 0: numpy in fp64."""
    q, k, v = (arrays[f"ring_{x}"].astype(np.float64) for x in "qkv")
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qh = q.reshape(B, T, Hkv, G, D).transpose(0, 2, 3, 1, 4)
    s = np.einsum("bhgtd,bshd->bhgts", qh, k) / np.sqrt(D)
    pos = o[:, None] + np.arange(T)[None]
    mask = ((pos[:, None, :] <= pos[:, :, None])
            & (pos[:, None, :] < kvl[:, None, None])
            & (pos[:, None, :] // W_ == pos[:, :, None] // W_))
    s = np.where(mask[:, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True)) * mask[:, None, None]
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-300)
    out = np.einsum("bhgts,bshd->bhgtd", p, v)
    return out.transpose(0, 3, 1, 2, 4).reshape(B, T, H, D)


# the forward_ring case also held to the JAX forward_ring on its mesh
JAX_RING_CASE = "ring 2x2"


def _forward_ring_goldens(arrays):
    """{case: (logits, cache)} of the JAX forward, and of the JAX
    forward_ring on the same mesh shape for ``JAX_RING_CASE``."""
    out = {}
    tokens = jnp.asarray(arrays["ring_tokens"])
    B, T = tokens.shape
    for name, (model, shape) in W.FORWARD_RINGS.items():
        cfg = _jax_config(model)
        logits, cache = _jax_forward(model)(
            jax_params(model), tokens, jnp.zeros(B, jnp.int32),
            jllama.new_kv_cache(cfg, B, T))
        out[name] = (np.asarray(logits), np.asarray(cache))
        if name == JAX_RING_CASE:
            devs = np.asarray(jax.devices()[:4]).reshape(shape)
            mesh = jax.sharding.Mesh(devs, ("data", "model"))
            ring = jax.jit(lambda p, t: jllama.forward_ring(p, cfg, t, mesh),
                           compiler_options=FAST_COMPILE)(
                jshard_params(jax.tree.map(jnp.asarray, jax_params(model)),
                              mesh), tokens)
            out["jax " + name] = tuple(np.asarray(a) for a in ring)
    return out


@functools.lru_cache(maxsize=None)
def _jax_forward(model):
    cfg = _jax_config(model)
    module = jmla if model == "mla" else jllama
    return jax.jit(lambda p, t, s, c: module.forward(p, cfg, t, s, c,
                                                     use_pallas=False),
                   compiler_options=FAST_COMPILE)


def _teacher_forced(model, prompt, tokens):
    """The JAX model's greedy choice at every position of ``prompt`` +
    ``tokens[:-1]``, one forward: what a greedy engine gives where the
    port's tokens are the JAX engine's."""
    cfg = _jax_config(model)
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    new = jmla.new_latent_cache if model == "mla" else jllama.new_kv_cache
    logits, _ = _jax_forward(model)(
        jax_params(model), jnp.asarray(seq)[None], jnp.zeros(1, jnp.int32),
        new(cfg, 1, len(seq)))
    return np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's arrays, the JAX side's beside them. The JAX work that
    does not need the ranks' tokens runs while they run."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    arrays, procs = _launch(tmp)
    try:
        jax_side = {"engines": _jax_mesh_engines(arrays),
                    "rings": _ring_references(arrays),
                    "forward_rings": _forward_ring_goldens(arrays)}
    finally:
        _join(procs)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(W.WORLD)]
    return arrays, ranks, jax_side


# -- single process ----------------------------------------------------------


@pytest.mark.parametrize("model", ["dense", "moe", "gpt_oss", "olmo2", "mla"])
def test_shard_params_match_the_jax_shards(model):
    """Each rank's slices are the JAX leaf's addressable shards on the
    device of its "model" index; the leaves that JAX replicates and GSPMD
    reshards at use (the column biases, sinks) are the matching slices of
    the whole leaf, the rest whole."""
    whole = jax_params(model)
    mesh = jmake_mesh(JMeshConfig(data=1, model=4))
    jax_tree = jshard_params(jax.tree.map(jnp.asarray, whole), mesh)
    devices = list(mesh.devices[0])
    torch_tree = jax.tree.map(torch.from_numpy, whole)
    follow = {"bq", "bk", "bv", "e_bg", "e_bu", "sinks"}
    for r in range(4):
        mine = shard_params(torch_tree, FakeMesh(1, 4, r))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
            keys = [p.key for p in path]
            got = mine
            for kk in keys:
                got = got[kk]
            got = got.numpy()
            if keys[-1] in follow:
                full = np.asarray(leaf)
                want = np.split(full, 4, axis=-1)[r]
                assert leaf.sharding.is_fully_replicated
            else:
                [shard] = [s for s in leaf.addressable_shards
                           if s.device == devices[r]]
                want = np.asarray(shard.data)
            np.testing.assert_array_equal(got, want, err_msg=str(keys))


@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
def test_shard_blob_slice_matches_jax(fmt):
    blob = np.random.default_rng(3).standard_normal((2, 2, 8, 8, 4))
    for i in range(4):
        want = np.asarray(jshard_blob_slice(blob, fmt, i, 4))
        np.testing.assert_array_equal(shard_blob_slice(blob, fmt, i, 4),
                                      want)
        np.testing.assert_array_equal(
            shard_blob_slice(torch.from_numpy(blob), fmt, i, 4).numpy(),
            want)
    with pytest.raises(ValueError):
        shard_blob_slice(blob, fmt, 0, 3)


@pytest.mark.parametrize("name, shape", [
    ("kv_cache_sharding", (2, 2, 4, 8, 16, 4)),
    ("latent_cache_sharding", (2, 4, 16, 6)),
    ("kv_blob_sharding", (2, 2, 16, 8, 4))])
def test_local_shapes_are_the_jax_shardings_shards(name, shape):
    """This rank's block of a pool or a blob laid out by each sharding is
    the shape of the JAX sharding's shard, on a (2, 4) mesh."""
    from jax.sharding import NamedSharding, PartitionSpec
    from lmcache_tpu.parallel import mesh as jpar
    from lmcache_tpu_torch import parallel as tpar
    want = getattr(jpar, name)(jmake_mesh(JMeshConfig(data=2, model=4)))
    spec = getattr(tpar, name)()
    assert want.spec == PartitionSpec(*spec)
    assert isinstance(want, NamedSharding)
    for r in range(8):
        assert tpar.local_shape(shape, spec, FakeMesh(2, 4, r)) == \
            want.shard_shape(shape)


@pytest.mark.parametrize("n_kv_heads, batch", [(4, 4), (2, 4), (4, 3)])
def test_pools_are_allocated_at_their_local_shapes(n_kv_heads, batch):
    """The allocators' blocks on each rank of a (2, 4) mesh are the JAX
    shardings' shards; a dim that does not divide its axis is whole, as
    JAX replicates it (kv heads that do not divide "model", which the
    forward gathers; a batch that does not divide "data")."""
    from jax.sharding import NamedSharding, PartitionSpec
    from lmcache_tpu.parallel import mesh as jpar
    from lmcache_tpu_torch.models import paged
    jmesh = jmake_mesh(JMeshConfig(data=2, model=4))
    cfg = llama.LlamaConfig.tiny(n_layers=2, n_heads=8,
                                 n_kv_heads=n_kv_heads, dim=64)
    mcfg = mla.MLAConfig.tiny(n_layers=2)
    S, P, pg = 24, 6, 8

    def shard(shape, spec):
        spec = [None if a is not None and n % jmesh.shape[a] else a
                for n, a in zip(shape, spec)]
        return NamedSharding(jmesh, PartitionSpec(*spec)).shard_shape(shape)

    kv = (2, 2, batch, n_kv_heads, S, cfg.head_dim)
    arena = (2, 2, P, n_kv_heads, pg, cfg.head_dim)
    latent = (2, batch, S, mcfg.latent_dim)
    kv_spec = jpar.kv_cache_sharding(jmesh).spec
    arena_spec = (None, None, None, "model", None, None)
    lat_spec = jpar.latent_cache_sharding(jmesh).spec
    for r in range(8):
        m = FakeMesh(2, 4, r)
        kw = dict(device="cpu", mesh=m)
        q = llama.new_quantized_kv_cache(cfg, batch, S, **kw)
        qa = paged.new_quantized_paged_pool(cfg, P, pg, **kw)
        ql = mla.new_quantized_latent_cache(mcfg, batch, S, **kw)
        got = {
            "kv": llama.new_kv_cache(cfg, batch, S, **kw).shape,
            "kv sym": q["sym"].shape, "kv scale": q["scale"].shape,
            "arena": paged.new_paged_kv_pool(cfg, P, pg, **kw).shape,
            "arena sym": qa["sym"].shape, "arena scale": qa["scale"].shape,
            "latent": mla.new_latent_cache(mcfg, batch, S, **kw).shape,
            "latent sym": ql["sym"].shape, "latent scale": ql["scale"].shape,
        }
        want = {
            "kv": shard(kv, kv_spec), "kv sym": shard(kv, kv_spec),
            "kv scale": shard(kv[:3] + kv[4:5], kv_spec[:3] + kv_spec[4:5]),
            "arena": shard(arena, arena_spec),
            "arena sym": shard(arena, arena_spec),
            "arena scale": shard(arena[:3] + arena[4:5],
                                 arena_spec[:3] + arena_spec[4:5]),
            "latent": shard(latent, lat_spec),
            "latent sym": shard(latent, lat_spec),
            "latent scale": shard(latent[:3], lat_spec[:3]),
        }
        assert {k: tuple(v) for k, v in got.items()} == want
        assert llama.kv_heads(cfg, m) == want["kv"][3]


def test_kv_shard_axis_names_the_worker():
    meta = LMCacheEngineMetadata(model_name="m", world_size=1, worker_id=0,
                                 fmt="vllm")
    assert meta.kv_shard_axis == JMetadata(
        model_name="m", world_size=1, worker_id=0,
        fmt="vllm").kv_shard_axis == "model"
    shard = shard_metadata(meta, FakeMesh(2, 4, 6))
    assert (shard.world_size, shard.worker_id) == (4, 2)
    data = shard_metadata(
        LMCacheEngineMetadata(model_name="m", world_size=1, worker_id=0,
                              fmt="vllm", kv_shard_axis="data"),
        FakeMesh(2, 4, 6))
    assert (data.world_size, data.worker_id) == (2, 1)


# -- four gloo ranks ---------------------------------------------------------

@pytest.mark.parametrize("case", JAX_ENGINE_CASES)
def test_engine_tokens_equal_the_jax_mesh_engine(results, case):
    """The tokens of the JAX mesh engine of the same engine, kv dtype and
    mesh shape (the int8 pools: a token's scale over every rank's heads,
    a max over "model")."""
    arrays, ranks, jax_side = results
    want = jax_side["engines"][_jax_key(case)]["tokens"]
    for r in ranks:
        assert r[case]["tokens"] == want


@pytest.mark.parametrize("case", W.TIERED)
def test_second_pass_retrieves_the_per_shard_tier(results, case):
    """A new mesh engine over the per-shard tier that the first engine's
    ranks filled: each rank retrieves its head slice (the ranks agreeing
    on the hit length; an int8 pool quantizing with its scale maxed over
    "model"; at (2, 2) only the slot's owners retrieving) and injects it,
    and the cached prefix lengths and tokens are those of the JAX mesh
    engine's second pass over its own tier."""
    _, ranks, jax_side = results
    want = jax_side["engines"][_jax_key(case)]
    assert all(n > 0 for n in want["second_cached"])
    for r in ranks:
        assert r[case]["second_cached"] == want["second_cached"]
        assert r[case]["second"] == want["second"]
    if "second_scale" in want:
        # the first injected chunk's scales: one a token over every head,
        # the same on every rank that holds the slot
        held = [r[case]["second_scale"] for r in ranks
                if r[case]["second_scale"] is not None]
        assert held
        for got in held:
            np.testing.assert_array_equal(got, held[0])
        np.testing.assert_allclose(held[0], want["second_scale"],
                                   rtol=ATOL_KV, atol=0)


@pytest.mark.parametrize("case", TEACHER_CASES)
def test_engine_tokens_are_the_jax_models_greedy_tokens(results, case):
    """One JAX forward over the prompt and the port's tokens: its greedy
    choice at every position is the port's next token, so a greedy JAX
    engine gives these tokens."""
    arrays, ranks, _ = results
    model = W.ENGINES[case][0]
    toks = ranks[0][case]["tokens"]
    for r in ranks:
        assert r[case]["tokens"] == toks
    for i, got in enumerate(toks):
        assert _teacher_forced(model, arrays[f"prompt{i}"], got) == got


@pytest.mark.parametrize("case", ["dense int8 2x2", "paged int8 1x4"])
def test_int8_engine_tokens_equal_the_port_without_a_mesh(results, case):
    """The int8 pools on a mesh (a token's scale over every rank's heads):
    the tokens of the same engine without one."""
    _, ranks, _ = results
    for r in ranks:
        assert r[case]["tokens"] == r[case]["plain"]


def test_per_shard_store_and_retrieve(results):
    """Each rank stored its head slice under its own worker id; the slices
    put back together are the blob the JAX mesh engine stored, and a
    deployment of another world size sees none of them."""
    arrays, ranks, jax_side = results
    want = jax_side["engines"][("dense", "native", (1, 4))]["blob"]
    res = ranks[0]["dense 1x4"]
    n = len(arrays["prompt0"])
    assert res["hits"] == [n] * 4
    assert res["other_world_hits"] == 0
    assert res["cached_prefix_len"] == 0
    got = np.concatenate(res["blob"], axis=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL_KV, rtol=ATOL_KV)


@pytest.mark.parametrize("case", sorted(W.BLENDS))
def test_cacheblend_tokens_equal_the_jax_mesh_engine(results, case):
    """A ``context_chunks`` request on a mesh: each rank blends its head
    slice (the deviation summed over "model", so that every rank heals the
    same tokens) or, for MLA, the whole latents with its query heads; at
    (2, 2) the slot's owners blend and broadcast the logits. The tokens and
    the reused prefix are the JAX mesh engine's, and the blender's last
    logits and healed blob the JAX blender's (2e-5, the port's blend files'
    rule)."""
    _, ranks, jax_side = results
    want = jax_side["engines"][_jax_blend_key(case)]["blend"]
    n = 3 * W.BLEND_DOCS
    for r in ranks:
        assert r[case]["tokens"] == want["tokens"]
        assert r[case]["cached"] == want["cached"]
        assert r[case]["recomputed"] == int(np.ceil(W.BLEND_RATIO * n))
        np.testing.assert_allclose(r[case]["logits"], want["logits"],
                                   atol=ATOL_KV, rtol=ATOL_KV)
    # the healed blob: the head slices of the "model" ranks put together
    # (the latents whole on every rank)
    model = W.BLENDS[case][2][1]
    parts = [ranks[m][case]["blob"] for m in range(model)]
    got = parts[0] if case.startswith("mla") else np.concatenate(parts, 3)
    np.testing.assert_allclose(got, want["blob"], atol=ATOL_KV,
                               rtol=ATOL_KV)


def _reassemble(ranks, key, shape, name, T_axis=1, head_axis=2,
                split_heads=True):
    """The whole array from the ranks' blocks: "data" blocks along
    ``T_axis``, "model" slices along ``head_axis``."""
    data, model = shape
    rows = []
    for d in range(data):
        parts = [ranks[d * model + m][name][key] for m in range(model)]
        rows.append(np.concatenate(parts, axis=head_axis)
                    if split_heads and model > 1 else parts[0])
    return np.concatenate(rows, axis=T_axis)


@pytest.mark.parametrize("case", sorted(W.RINGS))
def test_ring_attention_matches_jax(results, case):
    _, ranks, jax_side = results
    shape = W.RINGS[case][0]
    got = _reassemble(ranks, "out", shape, case)
    np.testing.assert_allclose(got, jax_side["rings"][case], atol=ATOL_RING,
                               rtol=ATOL_RING)


@pytest.mark.parametrize("case", sorted(W.FORWARD_RINGS))
def test_forward_ring_matches_the_jax_forward(results, case):
    _, ranks, jax_side = results
    model, shape = W.FORWARD_RINGS[case]
    logits, cache = jax_side["forward_rings"][case]
    got = _reassemble(ranks, "logits", shape, case, split_heads=False)
    np.testing.assert_allclose(got, logits, atol=ATOL_RING_LOGITS,
                               rtol=ATOL_RING_LOGITS)
    # cache [L, 2, B, H_kv', T / p, D]
    got_cache = _reassemble(ranks, "cache", shape, case, T_axis=4,
                            head_axis=3)
    np.testing.assert_allclose(got_cache, cache, atol=ATOL_KV, rtol=ATOL_KV)
    for r in ranks:
        np.testing.assert_allclose(r[case]["last"][:, 0], logits[:, -1],
                                   atol=ATOL_RING_LOGITS,
                                   rtol=ATOL_RING_LOGITS)
    if case == JAX_RING_CASE:
        ring_logits, ring_cache = jax_side["forward_rings"]["jax " + case]
        np.testing.assert_allclose(got, ring_logits, atol=ATOL_RING_LOGITS,
                                   rtol=ATOL_RING_LOGITS)
        np.testing.assert_allclose(got_cache, ring_cache, atol=ATOL_KV,
                                   rtol=ATOL_KV)
