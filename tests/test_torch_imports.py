"""The PyTorch port stands alone: it imports neither JAX nor lmcache_tpu,
and its entry points run on the CPU only when asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lmcache_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_jax_and_lmcache_tpu_out():
    code = ("import sys, lmcache_tpu_torch, lmcache_tpu_torch.serving, "
            "lmcache_tpu_torch.models, lmcache_tpu_torch.ops, "
            "lmcache_tpu_torch.models.paged, "
            "lmcache_tpu_torch.ops.paged_attention, "
            "lmcache_tpu_torch.ops.quantized_attention, "
            "lmcache_tpu_torch.ops.attention, "
            "lmcache_tpu_torch.serving.engine, "
            "lmcache_tpu_torch.serving.paged_engine, "
            "lmcache_tpu_torch.codec, lmcache_tpu_torch.codec.range_coder, "
            "lmcache_tpu_torch.ops.quant, lmcache_tpu_torch.ops.range_decode, "
            "lmcache_tpu_torch.ops.range_encode, "
            "lmcache_tpu_torch.storage.serde.cachegen_serde, "
            "lmcache_tpu_torch.storage.serde.raw_serde, "
            "lmcache_tpu_torch.storage.connector, lmcache_tpu_torch.net, "
            "lmcache_tpu_torch.storage.remote_backend, "
            "lmcache_tpu_torch.protocol, lmcache_tpu_torch.server, "
            "lmcache_tpu_torch.server.storage, "
            "lmcache_tpu_torch.models.mla, "
            "lmcache_tpu_torch.ops.latent_attention, "
            "lmcache_tpu_torch.ops.paged_latent_attention, "
            "lmcache_tpu_torch.serving.mla_engine, "
            "lmcache_tpu_torch.serving.mla_paged_engine, "
            "lmcache_tpu_torch.blend, lmcache_tpu_torch.blend_mla, "
            "lmcache_tpu_torch.ops.prefill_variants, "
            "lmcache_tpu_torch.tools, "
            "lmcache_tpu_torch.tools.bench_prefill_mfu, "
            "lmcache_tpu_torch.tools.eval_quality, "
            "lmcache_tpu_torch.tools.quality_common, "
            "lmcache_tpu_torch.storage.hybrid_backend, "
            "lmcache_tpu_torch.storage.serde.safe_serde, "
            "lmcache_tpu_torch.storage.connector.redis_connector, "
            "lmcache_tpu_torch.models.hf_checkpoint, "
            "lmcache_tpu_torch.serving.api, lmcache_tpu_torch.integration, "
            "lmcache_tpu_torch.tools.train_quality_model, "
            "lmcache_tpu_torch.tools.mesh_check, "
            "lmcache_tpu_torch.examples, "
            "lmcache_tpu_torch.examples.offline_inference, "
            "lmcache_tpu_torch.examples.save_decode_cache, "
            "lmcache_tpu_torch.examples.demo_tokenizer, "
            "lmcache_tpu_torch.examples.online_session, "
            "lmcache_tpu_torch.examples.chat_client, "
            "lmcache_tpu_torch.examples.frontend.serve, "
            "lmcache_tpu_torch.examples.share_across_instances.share, "
            "lmcache_tpu_torch.examples.disaggregated_prefill, "
            "lmcache_tpu_torch.examples.storage_backends.round_trip, "
            "lmcache_tpu_torch.examples.rag_blend, "
            "lmcache_tpu_torch.examples.speculative_decode, "
            "lmcache_tpu_torch.examples.mla_latent_cache, "
            "lmcache_tpu_torch.parallel, lmcache_tpu_torch.parallel.mesh, "
            "lmcache_tpu_torch.parallel.ring_attention; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lmcache_tpu' "
            "or m.startswith('lmcache_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_lmcache_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "lmcache_tpu", "tools",
                                "examples", "optax"), (
                f"{path}:{node.lineno} imports {name}")


# a subprocess in which importing jax or lmcache_tpu raises, running the
# port's cache server
_REFUSING_SERVER = """
import runpy, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lmcache_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["server", "localhost", sys.argv[1], "cpu"]
runpy.run_module("lmcache_tpu_torch.server", run_name="__main__",
                 alter_sys=True)
"""


def test_server_runs_with_jax_and_lmcache_tpu_refused():
    import socket
    import time

    from lmcache_tpu_torch.storage.connector.lm_connector import (
        LMCServerConnector)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-c", _REFUSING_SERVER,
                             str(port)], cwd=ROOT, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                client = LMCServerConnector("localhost", port, timeout=5)
                break
            except OSError:
                assert time.time() < deadline, "server did not start"
                time.sleep(0.1)
        assert client.ping()
        client.set("k", b"v" * 10)
        assert client.get("k") == b"v" * 10
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _entry_points():
    from lmcache_tpu_torch import LMCacheEngineConfig
    from lmcache_tpu_torch.models import llama, mla, paged
    from lmcache_tpu_torch.serving import (MLAPagedServingEngine,
                                           MLAServingEngine,
                                           PagedServingEngine, ServingEngine)
    from lmcache_tpu_torch.storage.local_backend import LMCLocalBackend
    from lmcache_tpu_torch.tools import (bench_prefill_mfu, eval_quality,
                                         mesh_check, train_quality_model)
    from lmcache_tpu_torch import examples, parallel
    from lmcache_tpu_torch.examples import (
        disaggregated_prefill, mla_latent_cache, offline_inference,
        online_session, rag_blend, save_decode_cache, speculative_decode)
    from lmcache_tpu_torch.examples.share_across_instances import share
    from lmcache_tpu_torch.examples.storage_backends import round_trip
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    mcfg = mla.MLAConfig.tiny(n_layers=1)
    return {
        "mla_init_params": lambda: mla.init_params(mcfg),
        "latent_cache": lambda: mla.new_latent_cache(mcfg, 1, 16),
        "quantized_latent_cache": lambda: mla.new_quantized_latent_cache(
            mcfg, 1, 16),
        "paged_latent_pool": lambda: mla.new_paged_latent_pool(mcfg, 4, 16),
        "quantized_paged_latent_pool":
            lambda: mla.new_quantized_paged_latent_pool(mcfg, 4, 16),
        "latent_pool_from_jax": lambda: mla.latent_pool_from_jax(
            np.zeros((1, 1, 16, 80), np.float32)),
        "mla_serving_engine": lambda: MLAServingEngine(mcfg, {}, max_seq=16),
        "mla_paged_serving_engine": lambda: MLAPagedServingEngine(
            mcfg, {}, max_seq=16, num_pages=4),
        "paged_pool": lambda: paged.new_paged_kv_pool(cfg, 4, 16),
        "quantized_paged_pool": lambda: paged.new_quantized_paged_pool(
            cfg, 4, 16),
        "paged_serving_engine": lambda: PagedServingEngine(cfg, {},
                                                           num_pages=4),
        "paged_pool_from_jax": lambda: llama.paged_pool_from_jax(
            np.zeros((1, 2, 4, 2, 16, 64), np.float32)),
        "init_params": lambda: llama.init_params(cfg),
        "new_kv_cache": lambda: llama.new_kv_cache(cfg, 1, 16),
        "new_quantized_kv_cache": lambda: llama.new_quantized_kv_cache(
            cfg, 1, 16),
        "quantized_pool_from_jax": lambda: llama.quantized_pool_from_jax(
            {"sym": np.zeros((1, 2, 1, 2, 16, 64), np.int8),
             "scale": np.ones((1, 2, 1, 16), np.float32)}),
        "int8_serving_engine": lambda: ServingEngine(cfg, {},
                                                     kv_dtype="int8"),
        "cuda_tier": lambda: LMCLocalBackend(),
        "serving_engine": lambda: ServingEngine(cfg, {}),
        "default_config_tier": lambda: LMCLocalBackend(
            LMCacheEngineConfig().local_device),
        "cachegen_remote_decoder": lambda: _cachegen_deserializer(),
        "prefill_ablation_tool": lambda: bench_prefill_mfu.run(small=True),
        "eval_quality_tool": lambda: eval_quality.evaluate("trained", 16, 4),
        "eval_quality_mla_tool": lambda: eval_quality.evaluate_mla(
            16, 4, trained=True),
        "hooks_default_tier": lambda: _hooks_engine(),
        "hybrid_tier": lambda: _tier("cuda"),
        "disk_hybrid_cachegen_tier": lambda: _tier("disk"),
        "train_quality_tool": lambda: train_quality_model.main(
            ["--out", "unwritten.npz"]),
        "train_quality_self_check": lambda: train_quality_model.self_check(
            "llama", None, bands=((256, 32),)),
        "examples_dense_model": lambda: examples.dense_model("cuda"),
        "offline_inference_example": offline_inference.main,
        "save_decode_cache_example": save_decode_cache.main,
        "online_session_example": online_session.main,
        "share_across_instances_example": share.main,
        "disaggregated_prefill_example": disaggregated_prefill.main,
        "storage_backends_example": round_trip.main,
        "rag_blend_example": rag_blend.main,
        "speculative_decode_example": speculative_decode.main,
        "mla_latent_cache_example": mla_latent_cache.main,
        "make_mesh": lambda: parallel.make_mesh(parallel.MeshConfig(1, 1)),
        "mesh_check_tool": lambda: mesh_check.main([]),
    }


def _hooks_engine():
    """The hook API's engine with the default config (the "cuda" tier)."""
    from lmcache_tpu_torch import integration
    try:
        return integration.init_lmcache_engine("m")
    finally:
        integration.close_lmcache_engine()


def _tier(local):
    """The hybrid tier over the "cuda" tier, or over the disk tier with the
    CacheGen serde (whose decoder takes the default remote_device), in
    front of a redis store (the test suite's fake)."""
    import tempfile

    from lmcache_tpu_torch import LMCacheEngineConfig, LMCacheEngineMetadata
    from lmcache_tpu_torch.storage import CreateStorageBackend
    meta = LMCacheEngineMetadata(model_name="m", world_size=1, worker_id=0,
                                 fmt="vllm")
    with tempfile.TemporaryDirectory() as d:
        cfg = LMCacheEngineConfig(
            local_device="cuda" if local == "cuda" else d,
            remote_url="redis://localhost:6379",
            remote_serde="raw" if local == "cuda" else "cachegen")
        return CreateStorageBackend(cfg, meta)


def _cachegen_deserializer():
    """The remote tier's CacheGen decoder with the default remote_device."""
    from lmcache_tpu_torch import LMCacheEngineConfig, LMCacheEngineMetadata
    from lmcache_tpu_torch.storage.serde.cachegen_serde import (
        CacheGenDeserializer)
    return CacheGenDeserializer(
        LMCacheEngineConfig(local_device=None, remote_url="lm://localhost:1",
                            remote_serde="cachegen"),
        LMCacheEngineMetadata(model_name="m", world_size=1, worker_id=0,
                              fmt="vllm"))


@pytest.mark.parametrize("name", ["init_params", "new_kv_cache", "cuda_tier",
                                  "serving_engine", "default_config_tier",
                                  "paged_pool", "quantized_paged_pool",
                                  "paged_serving_engine",
                                  "paged_pool_from_jax",
                                  "new_quantized_kv_cache",
                                  "quantized_pool_from_jax",
                                  "int8_serving_engine",
                                  "cachegen_remote_decoder",
                                  "mla_init_params", "latent_cache",
                                  "quantized_latent_cache",
                                  "paged_latent_pool",
                                  "quantized_paged_latent_pool",
                                  "latent_pool_from_jax",
                                  "mla_serving_engine",
                                  "mla_paged_serving_engine",
                                  "prefill_ablation_tool",
                                  "eval_quality_tool", "eval_quality_mla_tool",
                                  "hybrid_tier", "disk_hybrid_cachegen_tier",
                                  "hooks_default_tier", "train_quality_tool",
                                  "train_quality_self_check",
                                  "examples_dense_model",
                                  "offline_inference_example",
                                  "save_decode_cache_example",
                                  "online_session_example",
                                  "share_across_instances_example",
                                  "disaggregated_prefill_example",
                                  "storage_backends_example",
                                  "rag_blend_example",
                                  "speculative_decode_example",
                                  "mla_latent_cache_example",
                                  "make_mesh", "mesh_check_tool"])
def test_entry_point_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_entry_points_run_on_cpu_when_asked():
    from lmcache_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu")
    assert params["layers"]["wq"].device.type == "cpu"
    assert llama.new_kv_cache(cfg, 1, 16, device="cpu").device.type == "cpu"
    pool = llama.new_quantized_kv_cache(cfg, 1, 16, device="cpu")
    assert pool["sym"].device.type == "cpu" and pool["sym"].shape[4] == 16
    from lmcache_tpu_torch.serving import PagedServingEngine, ServingEngine
    dense = ServingEngine(cfg, params, max_batch=1, max_seq=32,
                          kv_dtype="int8", device="cpu")
    assert dense.kv_pool["scale"].device.type == "cpu"
    for kv_dtype in ("native", "int8"):
        eng = PagedServingEngine(cfg, params, num_pages=4, page_size=16,
                                 max_seq=32, kv_dtype=kv_dtype, device="cpu")
        pool = eng.kv_pool["sym"] if kv_dtype == "int8" else eng.kv_pool
        assert pool.device.type == "cpu" and pool.shape[2] == 4
    from lmcache_tpu_torch.models import mla
    from lmcache_tpu_torch.serving import (MLAPagedServingEngine,
                                           MLAServingEngine)
    mcfg = mla.MLAConfig.tiny(n_layers=1)
    mparams = mla.init_params(mcfg, device="cpu")
    assert mparams["dense_layers"]["wq"].device.type == "cpu"
    for kv_dtype in ("native", "int8"):
        eng = MLAServingEngine(mcfg, mparams, max_batch=1, max_seq=16,
                               kv_dtype=kv_dtype, device="cpu")
        pool = eng.kv_pool["sym"] if kv_dtype == "int8" else eng.kv_pool
        assert pool.device.type == "cpu" and pool.shape == (1, 1, 17, 80)
        eng = MLAPagedServingEngine(mcfg, mparams, num_pages=4, page_size=16,
                                    max_seq=32, kv_dtype=kv_dtype,
                                    device="cpu")
        pool = eng.kv_pool["sym"] if kv_dtype == "int8" else eng.kv_pool
        assert pool.device.type == "cpu" and pool.shape == (1, 4, 16, 128)


def test_a_mesh_needs_a_process_group_of_its_backend():
    """``make_mesh`` runs over an initialized process group whose backend
    is its device's (gloo for "cpu"; "cuda" needs CUDA and NCCL, and never
    carries on over gloo)."""
    from lmcache_tpu_torch import parallel
    with pytest.raises(RuntimeError, match="initialized"):
        parallel.make_mesh(parallel.MeshConfig(1, 1), "cpu")
